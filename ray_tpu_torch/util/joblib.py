"""joblib backend on the actor Pool.

Mirrors the reference's ray.util.joblib (python/ray/util/joblib/
__init__.py + ray_backend.py): ``register_ray()`` installs a "ray"
parallel backend so ``joblib.Parallel(backend="ray")`` fans out over
actors.
"""

from __future__ import annotations


def register_ray() -> None:
    try:
        from joblib import register_parallel_backend
        from joblib._parallel_backends import MultiprocessingBackend
    except ImportError as e:  # joblib not in the image — gate cleanly
        raise ImportError(
            "joblib is required for register_ray(); it is not installed"
        ) from e

    from ray_tpu_torch.util.multiprocessing import Pool

    class RayBackend(MultiprocessingBackend):
        """joblib backend whose worker pool is ray_tpu_torch actors."""

        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch

            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            if n_jobs is None or n_jobs == -1:
                n_jobs = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            return max(1, n_jobs)

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **memmapping_opts):
            n_jobs = self.effective_n_jobs(n_jobs)
            self._pool = Pool(processes=n_jobs)
            self.parallel = parallel
            return n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

    register_parallel_backend("ray", RayBackend)
