"""Deployment graphs — composable inference pipelines over deployments.

Reference: python/ray/serve/pipeline/ (experimental DAG API): steps are
sealed callables/classes deployed as replica groups; a pipeline is a DAG
of steps rooted at INPUT, executed by fanning calls out across the step
handles. Same shape here:

    @pipeline.step(num_replicas=2)
    def preprocess(x): ...

    @pipeline.step
    class Model:
        def __call__(self, x): ...

    graph = Model()(preprocess(pipeline.INPUT))
    deployed = graph.deploy("my_pipeline")
    deployed.call(payload)

Execution is handle-based: each step invocation becomes an actor task on
that step's deployment, upstream results flow in as resolved arguments,
and independent branches run concurrently (their ObjectRefs are awaited
together at the join)."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import ray_tpu_torch

_INPUT_SENTINEL = "__pipeline_input__"


class _Input:
    """Marker for the pipeline's runtime input."""

    def __repr__(self):
        return "pipeline.INPUT"


INPUT = _Input()


class Step:
    """A sealed computation unit; calling it on upstream nodes builds the
    graph (reference: serve/pipeline/step.py)."""

    def __init__(self, func_or_class, name: str,
                 num_replicas: int = 1,
                 ray_actor_options: Optional[dict] = None):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options or {}
        self._instance_args: Tuple = ()
        self._instance_kwargs: Dict = {}
        self._is_class = isinstance(func_or_class, type)
        self._bound = not self._is_class  # function steps wire directly

    def __call__(self, *args, **kwargs):
        if not self._bound:
            # class step: the FIRST call always binds constructor args
            # (even zero), the second wires the graph —
            # Model(init_args)(upstream). An explicit flag, not arg
            # sniffing: Gen()(42) must wire, not re-bind.
            bound = Step(self.func_or_class, self.name, self.num_replicas,
                         self.ray_actor_options)
            bound._instance_args = args
            bound._instance_kwargs = kwargs
            bound._bound = True
            return bound
        return PipelineNode(self, args, kwargs)

    def instantiate(self):
        if self._is_class:
            return self.func_or_class(*self._instance_args,
                                      **self._instance_kwargs)
        return self.func_or_class


class PipelineNode:
    """One step invocation in the DAG."""

    def __init__(self, step: Step, args: Tuple, kwargs: Dict):
        self.step = step
        self.args = args
        self.kwargs = kwargs

    def deploy(self, name: str = "pipeline") -> "DeployedPipeline":
        return DeployedPipeline(self, name)

    def __repr__(self):
        return f"PipelineNode({self.step.name})"


class _StepReplica:
    """Actor class hosting one step instance."""

    def __init__(self, step: Step):
        self._callable = step.instantiate()

    def handle_call(self, *args, **kwargs):
        return self._callable(*args, **kwargs)


class DeployedPipeline:
    """A live pipeline: every step backed by a pool of replica actors,
    calls routed round-robin (reference: pipeline deployments share the
    serve replica machinery)."""

    def __init__(self, root: PipelineNode, name: str):
        self.root = root
        self.name = name
        self._pools: Dict[str, List] = {}
        self._rr: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._deploy_steps(root)

    def _deploy_steps(self, node: PipelineNode) -> None:
        step = node.step
        if step.name not in self._pools:
            actor_cls = ray_tpu_torch.remote(_StepReplica)
            opts = dict(step.ray_actor_options)
            pool = [
                actor_cls.options(**opts).remote(step)
                for _ in range(step.num_replicas)
            ]
            self._pools[step.name] = pool
            self._rr[step.name] = 0
        for dep in list(node.args) + list(node.kwargs.values()):
            if isinstance(dep, PipelineNode):
                self._deploy_steps(dep)

    def _replica(self, step_name: str):
        with self._lock:
            pool = self._pools[step_name]
            idx = self._rr[step_name] % len(pool)
            self._rr[step_name] = idx + 1
            return pool[idx]

    def call(self, input_value: Any) -> Any:
        """Execute the DAG on one input. Shared nodes evaluate once;
        sibling branches run concurrently (unresolved ObjectRefs are only
        awaited where a downstream step consumes them)."""
        memo: Dict[int, Any] = {}
        ref = self._submit(self.root, input_value, memo)
        return ray_tpu_torch.get(ref)

    def call_many(self, inputs: List[Any]) -> List[Any]:
        memos = [{} for _ in inputs]
        refs = [self._submit(self.root, v, m)
                for v, m in zip(inputs, memos)]
        return ray_tpu_torch.get(refs)

    def _submit(self, node: Union[PipelineNode, _Input, Any],
                input_value: Any, memo: Dict[int, Any]):
        if isinstance(node, _Input):
            return input_value
        if not isinstance(node, PipelineNode):
            return node  # constant argument
        if id(node) in memo:
            return memo[id(node)]
        args = [self._submit(a, input_value, memo) for a in node.args]
        kwargs = {k: self._submit(v, input_value, memo)
                  for k, v in node.kwargs.items()}
        replica = self._replica(node.step.name)
        ref = replica.handle_call.remote(*args, **kwargs)
        memo[id(node)] = ref
        return ref

    def shutdown(self) -> None:
        import logging

        for pool in self._pools.values():
            for actor in pool:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception as e:
                    logging.getLogger(__name__).debug(
                        "killing pipeline step actor %r at shutdown "
                        "failed (already dead?): %r", actor, e)
        self._pools.clear()


def step(_func_or_class=None, *, num_replicas: int = 1,
         ray_actor_options: Optional[dict] = None,
         name: Optional[str] = None):
    """Decorator sealing a function/class into a pipeline Step."""

    def wrap(func_or_class):
        return Step(func_or_class,
                    name or getattr(func_or_class, "__name__", "step"),
                    num_replicas=num_replicas,
                    ray_actor_options=ray_actor_options)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
