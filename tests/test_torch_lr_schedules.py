"""The port's learning-rate schedules and append_LARS against the JAX
package's, on the CPU.

Each schedule (and variant: staircase, cycle, piecewise boundaries, noam)
is the lr of SGD on a small fc net, built by both packages (program JSON
equal), the JAX startup's state carried over by name. Six steps through
``Executor.run`` in each package: the fetched lr of every step within
1e-6 relative of the JAX package's, and the step counter equal after (the
port's is int64, the JAX package's int32 with x64 off: compared as
integers). The same six steps through the port's ``run_loop(3)`` twice
from the same state: the lr of steps 3 and 6 and the counter as ``run``
gave them. ``append_LARS`` (Momentum on an exponential decay): every
parameter's lr variable over six steps within 1e-6 of the JAX package's,
each port step from the JAX package's state of that step (the norms of
two trajectories whose fp32 sums differ in their last bits part by
~1e-6 after six steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import layers as jax_layers  # noqa: E402
from paddle_tpu import optimizer as jax_optimizer  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch import optimizer as pt_optimizer  # noqa: E402

JAX = (fluid, jax_layers, jax_optimizer)
PORT = (pt, pt_layers, pt_optimizer)
B, DIN, STEPS = 4, 8, 6

SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 2, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 2, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.4),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.4, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 4, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 2, 0.01,
                                                     power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([1, 3, 4], [0.1, 0.05, 0.02,
                                                         0.01]),
    "noam": lambda L: L.noam_decay(512, 4),
}


def _net(layers):
    x = layers.data(name="x", shape=[B, DIN], dtype="float32",
                    append_batch_size=False)
    y = layers.data(name="y", shape=[B, 1], dtype="float32",
                    append_batch_size=False)
    h = layers.fc(x, 16, act="relu")
    return layers.mean(layers.square(layers.elementwise_sub(
        layers.fc(h, 1), y)))


def _build(pkg, schedule=None, lars=False):
    fw, layers, optimizer = pkg
    prog, startup = fw.Program(), fw.Program()
    prog.random_seed = startup.random_seed = 9
    with fw.program_guard(prog, startup), fw.unique_name.guard():
        loss = _net(layers)
        if lars:
            lr = layers.exponential_decay(0.1, 2, 0.5)
            opt = optimizer.Momentum(lr, momentum=0.9)
            pgs = opt.backward(loss)
            layers.append_LARS(pgs, lr, 0.01)
            opt.apply_gradients(pgs)
            lrs = [p.optimize_attr["learning_rate"] for p, _ in pgs]
        else:
            lr = SCHEDULES[schedule](layers)
            optimizer.SGD(lr).minimize(loss)
            lrs = [lr]
    return prog, startup, loss, [v.name for v in lrs]


def _feed():
    r = np.random.RandomState(5)
    return {"x": r.standard_normal((B, DIN)).astype(np.float32),
            "y": r.standard_normal((B, 1)).astype(np.float32)}


def _parity(resync=False, **kw):
    """Both packages' six steps; returns (port program, the lr fetch
    names, the start state, the lr fetches by step, the counter after).
    With ``resync`` every port step starts from the JAX package's state
    (the two trajectories' fp32 sums part in their last bits)."""
    jprog, jstart, jloss, jlrs = _build(JAX, **kw)
    pprog, pstart, ploss, plrs = _build(PORT, **kw)
    assert pprog.to_json() == jprog.to_json()
    assert pstart.to_json() == jstart.to_json()
    assert plrs == jlrs
    exe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(jstart)
    names = [v.name for v in jprog.list_vars() if v.persistable]
    start = {n: np.asarray(jscope.find_var(n)) for n in names}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    for name, val in pt_io.state_from_numpy(start, pt.CPUPlace()).items():
        pscope.set_var(name, val)
    got_lrs = []
    for _ in range(STEPS):
        if resync:
            for name, val in pt_io.state_from_numpy(
                    {n: np.asarray(jscope.find_var(n)) for n in names},
                    pt.CPUPlace()).items():
                pscope.find_var(name).copy_(val)
        with fluid.scope_guard(jscope):
            want = exe.run(jprog, feed=_feed(), fetch_list=jlrs)
        got = pexe.run(pprog, feed=_feed(), fetch_list=plrs, scope=pscope)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        got_lrs.append(got)
    counter = "@STEP_COUNTER@"
    assert int(pscope.find_var(counter).numpy()[0]) == int(
        np.asarray(jscope.find_var(counter))[0])
    return pprog, plrs, start, got_lrs, int(pscope.find_var(counter)[0])


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_matches_jax_through_run_and_run_loop(schedule):
    pprog, plrs, start, got_lrs, counter = _parity(schedule=schedule)
    begin = 1 if schedule in ("noam", "piecewise") else 0
    assert counter == begin - 1 + STEPS
    if schedule == "noam":
        s = np.arange(1, STEPS + 1, dtype=np.float64)
        want = 512 ** -0.5 * np.minimum(s ** -0.5, s * 4 ** -1.5)
        np.testing.assert_allclose([float(v[0][0]) for v in got_lrs], want,
                                   rtol=1e-6)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    for name, val in pt_io.state_from_numpy(start, pt.CPUPlace()).items():
        pscope.set_var(name, val)
    for k in (3, 6):
        got = pexe.run_loop(pprog, feed=_feed(), fetch_list=plrs, steps=3,
                            scope=pscope)
        np.testing.assert_array_equal(got[0], got_lrs[k - 1][0])
    assert int(pscope.find_var("@STEP_COUNTER@")[0]) == counter


def test_append_lars_matches_jax():
    _, plrs, _, got_lrs, _ = _parity(resync=True, lars=True)
    assert len(plrs) == 4   # two fc layers' weights and biases
    assert not np.allclose(got_lrs[0][0], got_lrs[-1][0])
