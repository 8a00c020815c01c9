"""A helper for the port's parity tests: run JAX-package code without
leaving series in the JAX package's process-wide metric registry. Tests of
the JAX package read that registry in the same worker process (a fleet
test merges the process's own series with its workers'), so a parity
test that drives one of its servers puts the registry back as it was."""
import contextlib
import copy


@contextlib.contextmanager
def jax_metrics_untouched():
    from paddle_tpu import observability as jax_obs

    saved = {}
    for m in jax_obs.REGISTRY.collect():
        with m._lock:
            saved[m.name] = copy.deepcopy(m._series)
    try:
        yield
    finally:
        for m in jax_obs.REGISTRY.collect():
            with m._lock:
                m._series.clear()
                m._series.update(saved.get(m.name, {}))
