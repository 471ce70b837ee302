"""The port's ray_tpu_torch.workflow against the JAX package's
ray_tpu.workflow, on the CPU.

- Every scenario of tests/test_workflow.py runs on both packages, one
  runtime after the other (the port's on ``init(device="cpu")``), each
  in its own storage root; each side keeps that test's assertions and
  the results (outputs, statuses, listed ids, the order the steps ran
  in) are compared equal.
- The device rule: a tensor stored through ``FilesystemStorage`` comes
  back on the device it left, with its dtype and bits; one that left a
  card raises in a process without CUDA instead of landing on the CPU.
- The slice as a whole: ``ModelConfig.debug()`` from one seed, given to
  JAX as numpy and to the port through ``params_from_jax``, runs as the
  same four-step workflow in both packages (init -> train 2 steps ->
  train 2 steps, failing on its first attempt -> serve): the run fails,
  ``workflow.resume`` finishes it without re-running a finished step,
  and the losses and last-position logits agree within 1e-4.
"""

import contextlib
import importlib
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from test_torch_client import _end_jax_leftovers

SIDES = (("jax", ray_tpu), ("torch", ray_tpu_torch))
STEP_RTOL = 1e-4  # tests/test_torch_train.py's step tolerance
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_serve_model.py


def _workflow(core):
    return importlib.import_module(f"{core.__name__}.workflow")


@contextlib.contextmanager
def _side(core, root, num_cpus: int = 4):
    if core is ray_tpu_torch:
        core.init(num_cpus=num_cpus, device="cpu")
    else:
        _end_jax_leftovers()
        core.init(num_cpus=num_cpus)
    wf = _workflow(core)
    if root is not None:
        wf.init(storage=str(root))
    try:
        yield wf
    finally:
        wf.set_global_storage(None)
        core.shutdown()


def _on_both(tmp_path, scenario, num_cpus: int = 4, storage: bool = True):
    """``scenario(core, workflow, tmp)`` on the JAX runtime, then on the
    port's -> (JAX result, port result)."""
    out = []
    for name, core in SIDES:
        tmp = tmp_path / name
        tmp.mkdir()
        with _side(core, tmp / "wf" if storage else None, num_cpus) as wf:
            out.append(scenario(core, wf, tmp))
    return tuple(out)


def _both_equal(tmp_path, scenario, **kw):
    want, got = _on_both(tmp_path, scenario, **kw)
    assert got == want
    return got


# ------------------------------------------- tests/test_workflow.py on both


def test_basic_step_dag(tmp_path):
    def scenario(core, workflow, tmp):
        @workflow.step
        def add(a, b):
            return a + b

        @workflow.step
        def double(x):
            return 2 * x

        out = double.step(add.step(1, 2)).run("wf1")
        assert out == 6
        return (out, workflow.get_status("wf1"), workflow.get_output("wf1"),
                workflow.list_all())

    assert _both_equal(tmp_path, scenario) == (6, "SUCCESSFUL", 6, ["wf1"])


def test_continuation(tmp_path):
    def scenario(core, workflow, tmp):
        @workflow.step
        def final(x):
            return x * 10

        @workflow.step
        def entry(n):
            return final.step(n + 1)

        return entry.step(4).run("wf_cont")

    assert _both_equal(tmp_path, scenario) == 50


def _note(log, what) -> None:
    """Appends to a file: a resumed workflow runs unpickled copies of its
    steps, whose closures hold copies of any list they captured."""
    with open(log, "a") as f:
        f.write(what + "\n")


def _notes(log) -> list:
    return log.read_text().split() if log.exists() else []


def test_resume_skips_finished_steps(tmp_path):
    def scenario(core, workflow, tmp):
        log = tmp / "ran"
        marker = str(tmp / "marker")

        @workflow.step
        def flaky(marker_path):
            _note(log, "flaky")
            if not os.path.exists(marker_path):
                open(marker_path, "w").close()
                raise RuntimeError("first attempt dies")
            return "recovered"

        @workflow.step
        def pre():
            _note(log, "pre")
            return "input"

        @workflow.step
        def combine(a, b):
            _note(log, "combine")
            return f"{a}:{b}"

        node = combine.step(pre.step(), flaky.step(marker))
        with pytest.raises(Exception):
            node.run("wf_res")
        failed = workflow.get_status("wf_res")
        assert failed == "FAILED"
        out = workflow.resume("wf_res")
        assert out == "input:recovered"
        return failed, out, workflow.get_status("wf_res"), _notes(log)

    assert _both_equal(tmp_path, scenario) == (
        "FAILED", "input:recovered", "SUCCESSFUL",
        ["pre", "flaky", "flaky", "combine"])


def test_resume_successful_returns_cached(tmp_path):
    def scenario(core, workflow, tmp):
        log = tmp / "ran"

        @workflow.step
        def once():
            _note(log, "once")
            return 42

        once.step().run("wf_cache")
        return workflow.resume("wf_cache"), _notes(log)

    assert _both_equal(tmp_path, scenario) == (42, ["once"])


def test_step_retries(tmp_path):
    def scenario(core, workflow, tmp):
        attempts = tmp / "attempts"

        @workflow.step(max_retries=3)
        def sometimes():
            n = int(attempts.read_text()) if attempts.exists() else 0
            attempts.write_text(str(n + 1))
            if n < 2:
                raise ValueError("boom")
            return "ok"

        return sometimes.step().run("wf_retry"), attempts.read_text()

    assert _both_equal(tmp_path, scenario) == ("ok", "3")


def test_catch_exceptions(tmp_path):
    def scenario(core, workflow, tmp):
        @workflow.step(catch_exceptions=True)
        def fails():
            raise ValueError("expected")

        result, err = fails.step().run("wf_catch")
        assert result is None
        assert isinstance(err, Exception)
        return result, "expected" in str(err), workflow.get_status("wf_catch")

    assert _both_equal(tmp_path, scenario) == (None, True, "SUCCESSFUL")


def test_virtual_actor(tmp_path):
    def scenario(core, workflow, tmp):
        @workflow.virtual_actor
        class Counter:
            def __init__(self):
                self.count = 0

            def incr(self):
                self.count += 1
                return self.count

            def get(self):
                return self.count

        c = Counter.get_or_create("counter_1")
        seen = [c.incr.run(), c.incr.run()]
        # a new handle sees the durable state
        c2 = Counter.get_or_create("counter_1")
        seen.append(c2.get.run())
        return seen

    assert _both_equal(tmp_path, scenario) == [1, 2, 2]


def test_delete_and_list(tmp_path):
    def scenario(core, workflow, tmp):
        @workflow.step
        def one():
            return 1

        one.step().run("wf_del")
        before = workflow.list_all()
        workflow.delete("wf_del")
        return before, workflow.list_all()

    assert _both_equal(tmp_path, scenario) == (["wf_del"], [])


def test_workflow_run_cancel_and_get_actor(tmp_path):
    def scenario(core, workflow, tmp):
        @workflow.step
        def make(x):
            return x * 2

        # module-level run alias
        out = [workflow.run(make.step(21), workflow_id="wf-run")]
        # cancel blocks resume and get_output
        workflow.cancel("wf-run")
        out.append(workflow.get_status("wf-run"))
        with pytest.raises(ValueError):
            workflow.resume("wf-run")
        with pytest.raises(ValueError):
            workflow.get_output("wf-run")

        # virtual actor handle retrieval by id alone
        @workflow.virtual_actor
        class Tally:
            def __init__(self):
                self.total = 0

            def add(self, n):
                self.total += n
                return self.total

        h = Tally.get_or_create("tally-1")
        out.append(h.add.run(5))
        again = workflow.get_actor("tally-1")
        out.append(again.add.run(3))
        return out

    assert _both_equal(tmp_path, scenario, num_cpus=8) == [
        42, "CANCELED", 5, 8]


class _FileListener:
    """Mixed into each package's EventListener below."""

    def poll_for_event(self, path):
        return "fired" if os.path.exists(path) else None


def test_workflow_sleep_and_wait_for_event(tmp_path):
    def scenario(core, workflow, tmp):
        t0 = time.monotonic()
        slept = workflow.sleep(0.2).run("wf-sleep")
        assert time.monotonic() - t0 >= 0.2

        flag_file = tmp / "flag"
        listener = type("FileListener",
                        (_FileListener, workflow.EventListener), {})
        timer = threading.Timer(0.3, flag_file.write_text, args=("x",))
        timer.start()
        node = workflow.wait_for_event(listener, str(flag_file),
                                       poll_interval_s=0.05, timeout_s=10)
        fired = node.run("wf-event")
        timer.join()

        class NeverListener(workflow.EventListener):
            def poll_for_event(self):
                return None

        with pytest.raises(Exception):  # timeout surfaces through the step
            workflow.wait_for_event(NeverListener, poll_interval_s=0.05,
                                    timeout_s=0.2).run("wf-timeout")
        return (slept, fired, workflow.get_status("wf-event"),
                workflow.get_status("wf-timeout"))

    assert _both_equal(tmp_path, scenario, num_cpus=8) == (
        None, "fired", "SUCCESSFUL", "FAILED")


def test_cancel_stops_running_workflow(tmp_path):
    """Cancellation takes effect at the next checkpoint boundary and is
    never overwritten by the drive loop's terminal status."""
    def scenario(core, workflow, tmp):
        @workflow.step
        def slow(x):
            time.sleep(0.3)
            return x

        # chain: slow -> slow -> slow ; cancel after launch
        node = slow.step(slow.step(slow.step(1)))
        ref = node.run_async("wf-cancel-mid")
        deadline = time.monotonic() + 10
        while workflow.get_status("wf-cancel-mid") != "RUNNING" \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        workflow.cancel("wf-cancel-mid")
        with pytest.raises(Exception):
            core.get([ref], timeout=30)
        status = workflow.get_status("wf-cancel-mid")
        with pytest.raises(ValueError):
            workflow.resume("wf-cancel-mid")
        # unknown ids raise instead of minting phantom records
        with pytest.raises(ValueError):
            workflow.cancel("no-such-wf")
        with pytest.raises(KeyError):
            workflow.get_actor("no-such-actor")
        return status, workflow.list_all()

    assert _both_equal(tmp_path, scenario, num_cpus=8) == (
        "CANCELED", ["wf-cancel-mid"])


# --------------------------------------------------------------------- S3


def _s3(core):
    return importlib.import_module(f"{core.__name__}.workflow.s3_storage")


def _on_both_s3(tmp_path, scenario):
    """Workflows against each package's S3-style backend over its own
    FakeS3Client -> (JAX result, port result)."""
    out = []
    for name, core in SIDES:
        s3 = _s3(core)
        client = s3.FakeS3Client()
        with _side(core, None) as wf:
            wf.set_global_storage(s3.S3Storage(client, "wf-bucket", "flows"))
            out.append(scenario(wf, client))
    return tuple(out)


def test_s3_storage_runs_workflow(tmp_path):
    def scenario(workflow, client):
        @workflow.step
        def add(a, b):
            return a + b

        @workflow.step
        def double(x):
            return 2 * x

        out = double.step(add.step(2, 3)).run("s3wf")
        # checkpoints actually live in the bucket under the prefix
        keys = sorted(k for k in client._buckets["wf-bucket"]
                      if k.startswith("flows/s3wf/"))
        assert keys, "no checkpoints written to the bucket"
        steps = {k.split("/")[3] for k in keys if "/steps/" in k}
        return (out, workflow.get_status("s3wf"), workflow.get_output("s3wf"),
                len(steps), [k for k in keys if "/steps/" not in k])

    want, got = _on_both_s3(tmp_path, scenario)
    assert got == want
    assert got[:4] == (10, "SUCCESSFUL", 10, 2)


def test_s3_storage_resume(tmp_path):
    def scenario(workflow, client):
        calls = {"n": 0}

        @workflow.step
        def work():
            calls["n"] += 1
            return 41

        @workflow.step
        def finish(x):
            return x + 1

        first = finish.step(work.step()).run("s3resume")
        # resume replays from checkpoints: no step re-executes
        return first, workflow.resume("s3resume"), calls["n"]

    want, got = _on_both_s3(tmp_path, scenario)
    assert got == want == (42, 42, 1)


@pytest.mark.parametrize("side", [name for name, _ in SIDES])
def test_s3_storage_interface(side):
    core = dict(SIDES)[side]
    s3 = _s3(core)
    s = s3.S3Storage(s3.FakeS3Client(), "b", "p")
    assert s.get("missing", "dflt") == "dflt"
    assert not s.exists("missing")
    s.put("a/x", {"v": 1})
    s.put("a/y/z", 2)
    assert s.exists("a/x") and s.get("a/x") == {"v": 1}
    assert s.list_prefix("a") == ["x", "y"]
    s.delete_prefix("a")
    assert not s.exists("a/x") and s.list_prefix("a") == []


def test_s3_storage_update_is_atomic():
    from ray_tpu_torch.workflow.s3_storage import FakeS3Client, S3Storage

    s = S3Storage(FakeS3Client(), "b", "p")
    s.put("counter", 0)
    errors = []

    def bump():
        try:
            for _ in range(20):
                s.update("counter", lambda v: (v or 0) + 1)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert s.get("counter") == 80  # no lost updates under contention


def test_s3_storage_pagination_and_prefix_boundary():
    """Pages of 7 keys (real S3 truncates at 1000), and delete keeps to
    the '/' boundary: delete('wf1') must not destroy 'wf10'. The two
    packages' fake buckets hold the same bytes' keys throughout."""
    seen = []
    for _, core in SIDES:
        s3 = _s3(core)
        client = s3.FakeS3Client(page_size=7)
        s = s3.S3Storage(client, "b", "p")
        for i in range(25):
            s.put(f"wf1/steps/s{i:02d}/out", i)
        s.put("wf10/steps/s0/out", "other workflow")
        listed = s.list_prefix("wf1/steps")
        assert len(listed) == 25  # crosses 4 pages
        s.delete_prefix("wf1")
        assert s.list_prefix("wf1/steps") == []
        assert s.get("wf10/steps/s0/out") == "other workflow"  # survived
        seen.append((listed, sorted(client._buckets["b"])))
    assert seen[1] == seen[0]


def test_storage_from_url_routes_like_the_jax_package(tmp_path):
    from ray_tpu.workflow.s3_storage import storage_from_url as j_from_url
    from ray_tpu_torch.workflow.s3_storage import storage_from_url
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    local = storage_from_url(str(tmp_path / "fs"))
    assert isinstance(local, FilesystemStorage)
    assert local.root == j_from_url(str(tmp_path / "fs")).root
    # neither machine has boto3: both refuse s3:// the same way
    with pytest.raises(RuntimeError, match="boto3") as want:
        j_from_url("s3://bucket/prefix")
    with pytest.raises(RuntimeError, match="boto3") as got:
        storage_from_url("s3://bucket/prefix")
    assert str(got.value) == str(want.value)


def test_filesystem_storage_bytes_equal_the_jax_package(tmp_path):
    """A value's checkpoint file is the JAX package's, byte for byte,
    and each package reads the other's."""
    from ray_tpu.workflow.storage import FilesystemStorage as JStorage
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    value = {"status": "RUNNING", "steps": [1, 2.5, "x"], "t": (None,)}
    j, t = JStorage(str(tmp_path / "j")), FilesystemStorage(
        str(tmp_path / "t"))
    j.put("wf/meta.json", value)
    t.put("wf/meta.json", value)
    assert (tmp_path / "j/wf/meta.json").read_bytes() == \
        (tmp_path / "t/wf/meta.json").read_bytes()
    assert FilesystemStorage(str(tmp_path / "j")).get("wf/meta.json") == \
        JStorage(str(tmp_path / "t")).get("wf/meta.json") == value
    assert t.update("wf/meta.json", lambda m: {**m, "status": "DONE"}) == \
        j.update("wf/meta.json", lambda m: {**m, "status": "DONE"})
    assert t.list_prefix("wf") == j.list_prefix("wf") == [
        "meta.json", "meta.json.lock"]


# ------------------------------------------------------------ device rule


def test_tensor_checkpoint_keeps_device_dtype_and_bits(tmp_path):
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    gen = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=gen),
               "bf16": torch.randn(4, 2, generator=gen).to(torch.bfloat16),
               "i32": torch.arange(7, dtype=torch.int32)}
    s = FilesystemStorage(str(tmp_path))
    s.put("wf/steps/s/output.pkl", (tensors, "tail"))
    back, tail = s.get("wf/steps/s/output.pkl")
    assert tail == "tail"
    for name, t in tensors.items():
        assert back[name].device == t.device
        assert back[name].dtype == t.dtype
        assert torch.equal(back[name], t)


@contextlib.contextmanager
def _tagged_as_cuda():
    """torch pickles each tensor's storage with its location tag; tag a
    CPU storage as cuda:0, as the card's would be tagged."""
    import torch.serialization as ser

    saved = ser.location_tag
    ser.location_tag = lambda storage: "cuda:0"
    try:
        yield
    finally:
        ser.location_tag = saved


def test_a_card_tensor_does_not_land_on_the_cpu(tmp_path):
    """A tensor that left the card loads back onto the card: in a
    process without CUDA, reading its checkpoint raises instead of
    placing it on the CPU (the JAX package's pickled arrays land on the
    reader's default device)."""
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the read would succeed")
    s = FilesystemStorage(str(tmp_path))
    with _tagged_as_cuda():
        s.put("wf/result.pkl", {"logits": torch.ones(2, 3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        s.get("wf/result.pkl")


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_card_tensor_round_trips_on_the_card(tmp_path):
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    t = torch.arange(6, device="cuda", dtype=torch.float32)
    s = FilesystemStorage(str(tmp_path))
    s.put("k", t)
    back = s.get("k")
    assert back.device == t.device and torch.equal(back, t)


# ------------------------------------------------- the slice on the CPU

DEBUG_VOCAB = 256  # ModelConfig.debug()'s, in both packages
_LOG = []  # (package, step) as each step body runs, in this process


def _batch(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, size=(2, 33))


def _prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(2).integers(0, vocab, size=(2, 32))


def _np_params():
    import jax

    from ray_tpu.models import transformer as jtfm

    params = jtfm.init_params(jtfm.ModelConfig.debug(),
                              jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _flaky(attempt_marker: str) -> None:
    if attempt_marker and not os.path.exists(attempt_marker):
        open(attempt_marker, "w").close()
        raise RuntimeError("the train step dies on its first attempt")


# JAX side: the state is a pickle of numpy trees in the step's directory


def j_init(ckpt_dir, seed):
    import jax

    from ray_tpu.models.training import build_train_step
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    _LOG.append(("jax", "init"))
    _, init_fn = build_train_step(jtfm.ModelConfig.debug(),
                                  build_mesh(MeshSpec(dp=1, pp=1, sp=1,
                                                      tp=1)))
    params, state = init_fn(jax.random.PRNGKey(seed))
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "0.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, (params, state)), f)
    return ckpt_dir


def j_train(prev, steps, attempt_marker=""):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_train_step
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    ckpt_dir = prev if isinstance(prev, str) else prev[0]
    _LOG.append(("jax", "train"))
    _flaky(attempt_marker)
    cfg = jtfm.ModelConfig.debug()
    step, _ = build_train_step(cfg, build_mesh(MeshSpec(dp=1, pp=1, sp=1,
                                                        tp=1)))
    done = max(int(n.split(".")[0]) for n in os.listdir(ckpt_dir))
    with open(os.path.join(ckpt_dir, f"{done}.pkl"), "rb") as f:
        params, state = jax.tree.map(jnp.asarray, pickle.load(f))
    tokens = jnp.asarray(_batch(cfg.vocab_size), jnp.int32)
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, tokens)
        losses.append(float(m["loss"]))
    with open(os.path.join(ckpt_dir, f"{done + steps}.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, (params, state)), f)
    return ckpt_dir, losses


def j_serve(prev, prompts):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.models.training import build_forward

    ckpt_dir = prev[0]
    _LOG.append(("jax", "serve"))
    done = max(int(n.split(".")[0]) for n in os.listdir(ckpt_dir))
    with open(os.path.join(ckpt_dir, f"{done}.pkl"), "rb") as f:
        params, _ = pickle.load(f)
    fwd = build_forward(jtfm.ModelConfig.debug())
    logits = fwd(jax.tree.map(jnp.asarray, params),
                 jnp.asarray(prompts, jnp.int32))
    return np.asarray(logits[:, -1], np.float32)


# port side: the state through models/checkpoint.py, as on the card


def t_init(ckpt_dir, np_params):
    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.training import make_optimizer
    from ray_tpu_torch.models.transformer import ModelConfig

    _LOG.append(("torch", "init"))
    params = params_from_jax(np_params, ModelConfig.debug(), device="cpu")
    state = make_optimizer().init(params)
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=None)
    ckpt.save(0, {"params": params, "opt_state": state})
    return ckpt_dir


def t_train(prev, steps, attempt_marker=""):
    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_train_step
    from ray_tpu_torch.models.transformer import ModelConfig

    ckpt_dir = prev if isinstance(prev, str) else prev[0]
    _LOG.append(("torch", "train"))
    _flaky(attempt_marker)
    cfg = ModelConfig.debug()
    step, _ = build_train_step(cfg, device="cpu")
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=None, create=False)
    done = ckpt.latest_step()
    restored = ckpt.restore(done)
    params, state = restored["params"], restored["opt_state"]
    tokens = torch.as_tensor(_batch(cfg.vocab_size), dtype=torch.int32)
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, tokens)
        losses.append(m["loss"].item())
    ckpt.save(done + steps, {"params": params, "opt_state": state})
    return ckpt_dir, losses


def t_serve(prev, prompts):
    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.models.transformer import ModelConfig

    ckpt_dir = prev[0]
    _LOG.append(("torch", "serve"))
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=None, create=False)
    params = ckpt.restore(ckpt.latest_step())["params"]
    fwd = build_forward(ModelConfig.debug(), device="cpu")
    return fwd(params, prompts)[:, -1]


def _four_steps(workflow, init, train, serve, init_arg, ckpt_dir, marker):
    """init -> train 2 -> train 2 (dies on its first attempt) -> serve;
    the result is (losses of both train steps, last-position logits)."""
    init_s, train_s, serve_s = (workflow.step(f) for f in (init, train,
                                                            serve))
    first = train_s.step(init_s.step(ckpt_dir, init_arg), 2)
    second = train_s.options(max_retries=0).step(first, 2, marker)

    @workflow.step
    def result(a, b, logits):
        return a[1] + b[1], logits

    return result.step(first, second, serve_s.step(second, _prompts(
        DEBUG_VOCAB)))


def test_debug_model_workflow_resumed_matches_jax(tmp_path):
    """The slice on the CPU: the same four-step workflow of
    ModelConfig.debug() in both packages fails at its third step, and
    resume finishes it from the stored outputs of the first two; the
    losses agree within STEP_RTOL and the logits within MODEL_TOL."""
    np_params = _np_params()
    sides = {"jax": (j_init, j_train, j_serve, 0),
             "torch": (t_init, t_train, t_serve, np_params)}
    results = {}
    for name, core in SIDES:
        init, train, serve, init_arg = sides[name]
        tmp = tmp_path / name
        tmp.mkdir()
        _LOG.clear()
        with _side(core, tmp / "wf") as workflow:
            node = _four_steps(workflow, init, train, serve, init_arg,
                               str(tmp / "ckpt"), str(tmp / "attempted"))
            with pytest.raises(Exception, match="first attempt"):
                node.run("debug-lm")
            assert workflow.get_status("debug-lm") == "FAILED"
            before = list(_LOG)
            _LOG.clear()
            losses, logits = workflow.resume("debug-lm")
            assert workflow.get_status("debug-lm") == "SUCCESSFUL"
            stored = workflow.get_output("debug-lm")
            resumed = list(_LOG)
        # the resumed run ran only the steps that had not finished
        assert before == [(name, "init"), (name, "train"), (name, "train")]
        assert resumed == [(name, "train"), (name, "serve")]
        if name == "torch":
            assert logits.device == torch.device("cpu")
            assert torch.equal(stored[1], logits)
            logits = logits.numpy()
        else:
            np.testing.assert_array_equal(stored[1], logits)
        assert stored[0] == losses
        results[name] = (np.asarray(losses), np.asarray(logits))
    (jl, jlog), (tl, tlog) = results["jax"], results["torch"]
    assert len(tl) == 4 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=STEP_RTOL)
    assert tlog.shape == (2, 256) and np.isfinite(tlog).all()
    np.testing.assert_allclose(tlog, jlog, **MODEL_TOL)


def test_debug_model_workflow_resumed_equals_uninterrupted(tmp_path):
    """The port alone: the failed-and-resumed run and an uninterrupted
    run of the same DAG under another id give equal losses and logits,
    bit for bit (the card's check at full size, on the CPU)."""
    np_params = _np_params()
    out = {}
    with _side(ray_tpu_torch, tmp_path / "wf") as workflow:
        for wid, marker in (("resumed", str(tmp_path / "attempted")),
                            ("uninterrupted", "")):
            node = _four_steps(workflow, t_init, t_train, t_serve, np_params,
                               str(tmp_path / wid), marker)
            if marker:
                with pytest.raises(Exception, match="first attempt"):
                    node.run(wid)
                out[wid] = workflow.resume(wid)
            else:
                out[wid] = node.run(wid)
        assert sorted(workflow.list_all()) == ["resumed", "uninterrupted"]
    assert out["resumed"][0] == out["uninterrupted"][0]
    assert torch.equal(out["resumed"][1], out["uninterrupted"][1])


def test_stored_step_output_pickles_as_the_jax_package_reads_it(tmp_path):
    """The numpy leg of the device rule: a port workflow's stored numpy
    output is read by the JAX package's storage as written."""
    from ray_tpu.workflow.storage import FilesystemStorage as JStorage
    from ray_tpu_torch.workflow.storage import FilesystemStorage

    value = (np.arange(6, dtype=np.float32).reshape(2, 3), [0.5, 0.25])
    FilesystemStorage(str(tmp_path)).put("wf/result.pkl", value)
    back = JStorage(str(tmp_path)).get("wf/result.pkl")
    np.testing.assert_array_equal(back[0], value[0])
    assert back[0].dtype == np.float32 and back[1] == value[1]
