"""The port's training surface against the JAX package's, on the CPU.

- The ported math families (elementwise, unary, compare; clip,
  clip_by_norm, sum, increment): each op's kernel against the JAX
  package's on the same seeded numpy inputs, 1e-6 relative (bool and
  integer outputs exact), the output dtype as jnp gives it.
- The 11 optimizer ops (ops/optim.py): every output against the JAX
  kernel's, 1e-6 relative.
- Every optimizer class (and alias) builds the same op types, attrs and
  accumulator names as the JAX package's: the programs serialize equal.
- 3 steps of a small fc net (8 -> 16 relu -> 1, squared error) per
  optimizer, per gradient clip and per weight decay, the JAX startup's
  state carried over by name: every loss and every persistable
  (parameters and accumulators) within 1e-5 relative + 1e-7.
- ``ModelAverage``: ``apply`` writes the JAX package's averages into the
  parameters, ``restore`` puts back the values, and the step after
  ``restore`` equals the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import clip as jax_clip  # noqa: E402
from paddle_tpu import layers as jax_layers  # noqa: E402
from paddle_tpu import optimizer as jax_optimizer  # noqa: E402
from paddle_tpu import regularizer as jax_reg  # noqa: E402
from paddle_tpu.ops import registry as jax_registry  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import clip as pt_clip  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch import optimizer as pt_optimizer  # noqa: E402
from paddle_tpu_torch import regularizer as pt_reg  # noqa: E402
from paddle_tpu_torch.ops import registry as pt_registry  # noqa: E402

JAX = (fluid, jax_layers, jax_optimizer, jax_clip, jax_reg)
PORT = (pt, pt_layers, pt_optimizer, pt_clip, pt_reg)


class _Ctx:
    """The smallest op context both registries' kernels read."""

    def __init__(self, inputs, attrs):
        self._inputs, self._attrs = inputs, attrs

    def input(self, slot, default=None):
        got = self._inputs.get(slot, default)
        return got[0] if isinstance(got, list) else got

    def inputs(self, slot):
        return list(self._inputs[slot])

    def has_input(self, slot):
        return slot in self._inputs

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def _run_both(op_type, arrays, attrs):
    """(port outputs, JAX outputs) of ``op_type`` on numpy ``arrays``."""
    def conv(fn):
        return {k: [fn(a) for a in v] if isinstance(v, list) else fn(v)
                for k, v in arrays.items()}

    want = jax_registry.get_kernel(op_type)(_Ctx(conv(jnp.asarray), attrs))
    got = pt_registry.get_kernel(op_type)(_Ctx(conv(torch.from_numpy),
                                               attrs))
    assert set(got) == set(want)
    return got, want


def _check(got, want, rtol=1e-6):
    for slot in want:
        a, b = got[slot].numpy(), np.asarray(want[slot])
        assert a.shape == b.shape, slot
        assert a.dtype == b.dtype or (b.dtype == np.int32
                                      and a.dtype == np.int64), (
            slot, a.dtype, b.dtype)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=slot)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(
                float(np.abs(b).max()), 1e-30), err_msg=slot)


# -- the math families ------------------------------------------------------

_R = np.random.RandomState(3)
_X = _R.uniform(-3, 3, (4, 6)).astype(np.float32)
_POS = _R.uniform(0.2, 3, (4, 6)).astype(np.float32)
_Y = _R.uniform(-3, 3, (6,)).astype(np.float32)
_YPOS = _R.uniform(0.5, 2, (6,)).astype(np.float32)
_TIES = np.round(_X).astype(np.float32)

ELEMENTWISE = ["elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_div", "elementwise_max", "elementwise_min",
               "elementwise_pow", "elementwise_mod"]
UNARY = ["sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
         "sqrt", "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal",
         "square", "softplus", "softsign", "log", "sign"]
COMPARE = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "logical_and", "logical_or", "logical_xor"]


def _math_case(op):
    if op in ELEMENTWISE:
        x = _POS if op in ("elementwise_pow", "elementwise_mod") else _X
        y = _YPOS if op in ("elementwise_pow", "elementwise_mod",
                            "elementwise_div") else _Y
        return {"X": x, "Y": y}, {"axis": -1}
    if op in UNARY:
        x = _POS if op in ("sqrt", "log", "reciprocal") else _X
        return {"X": x}, {}
    if op in COMPARE:
        if op.startswith("logical"):
            return {"X": _X > 0, "Y": _TIES > 0}, {}
        return {"X": _TIES, "Y": np.round(_X[::-1]).astype(np.float32)}, {}
    return {
        "logical_not": ({"X": _X > 0}, {}),
        "isfinite": ({"X": np.array([1.0, np.inf], np.float32)}, {}),
        "clip": ({"X": _X}, {"min": -1.5, "max": 0.5}),
        "clip_by_norm": ({"X": _X}, {"max_norm": 2.0}),
        "sum": ({"X": [_X, _POS, _TIES]}, {}),
        "increment": ({"X": np.array([7], np.int64)}, {"step": 2.0}),
    }[op]


@pytest.mark.parametrize("op", ELEMENTWISE + UNARY + COMPARE + [
    "logical_not", "isfinite", "clip", "clip_by_norm", "sum", "increment"])
def test_math_families_match_jax(op):
    arrays, attrs = _math_case(op)
    got, want = _run_both(op, arrays, attrs)
    _check(got, want)


def test_clip_by_norm_under_its_bound_and_float_increment():
    got, want = _run_both("clip_by_norm", {"X": _X * 1e-3},
                          {"max_norm": 2.0})
    _check(got, want)
    got, want = _run_both("increment", {"X": np.array([0.5], np.float32)},
                          {"step": 1.0})
    _check(got, want)


# -- the optimizer ops -------------------------------------------------------


def _opt_case(op, r):
    shape = (5, 7)

    def n(scale=1.0):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    def pos(scale=1.0):
        return (np.abs(r.standard_normal(shape)) * scale + 1e-3).astype(
            np.float32)

    lr = np.array([0.01], np.float32)
    base = {"Param": n(), "Grad": n(0.1), "LearningRate": lr}
    cases = {
        "sgd": ({}, {}),
        "momentum": ({"Velocity": n(0.1)}, {"mu": 0.9}),
        "adamax": ({"Moment": n(0.01), "InfNorm": pos(0.1),
                    "Beta1Pow": np.array([0.9 ** 3], np.float32)},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ({"Moment": pos(0.1)}, {"epsilon": 1e-6}),
        "decayed_adagrad": ({"Moment": pos(0.1)},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ({"AvgSquaredGrad": pos(0.01),
                      "AvgSquaredUpdate": pos(0.01)},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "rmsprop": ({"MeanSquare": pos(0.01), "Moment": n(0.01)},
                    {"decay": 0.9, "momentum": 0.5, "epsilon": 1e-10}),
        "ftrl": ({"SquaredAccumulator": pos(0.1),
                  "LinearAccumulator": n(0.1)},
                 {"l1": 0.05, "l2": 0.01, "lr_power": -0.5}),
        "proximal_gd": ({}, {"l1": 0.01, "l2": 0.02}),
        "proximal_adagrad": ({"Moment": pos(0.1)}, {"l1": 0.01, "l2": 0.02}),
    }
    if op == "average_accumulates":
        return ({"param": n(), "in_sum_1": n(), "in_sum_2": n(),
                 "in_sum_3": n(),
                 "in_num_accumulates": np.array([4], np.int64),
                 "in_old_num_accumulates": np.array([2], np.int64),
                 "in_num_updates": np.array([16383], np.int64)},
                {"average_window": 0.5, "max_average_window": 5,
                 "min_average_window": 5})
    extra, attrs = cases[op]
    return {**base, **extra}, attrs


OPT_OPS = ["sgd", "momentum", "adamax", "adagrad", "decayed_adagrad",
           "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
           "average_accumulates"]


@pytest.mark.parametrize("op", OPT_OPS)
def test_optimizer_ops_match_jax(op):
    arrays, attrs = _opt_case(op, np.random.RandomState(len(op)))
    got, want = _run_both(op, arrays, attrs)
    _check(got, want)
    if op == "momentum":   # and with Nesterov
        _check(*_run_both(op, arrays, {**attrs, "use_nesterov": True}))
    if op == "ftrl":       # and another lr power
        _check(*_run_both(op, arrays, {**attrs, "lr_power": -0.7}))
    if op == "average_accumulates":
        # the window fills (num_updates spills at 16384, then rolls)
        assert int(got["out_num_accumulates"][0]) == 0
        assert int(got["out_old_num_accumulates"][0]) == 5


# -- the optimizer classes, clips and decays on a small fc net ---------------

B, DIN, H = 4, 8, 16


def _opt(pkg, kind):
    opt, clip, reg = pkg[2], pkg[3], pkg[4]
    return {
        "SGD": lambda: opt.SGD(0.1),
        "Momentum": lambda: opt.Momentum(0.05, momentum=0.9),
        "Momentum_nesterov": lambda: opt.MomentumOptimizer(
            0.05, momentum=0.9, use_nesterov=True),
        "Adagrad": lambda: opt.Adagrad(0.1),
        "Adam": lambda: opt.AdamOptimizer(0.01),
        "Adamax": lambda: opt.Adamax(0.01),
        "DecayedAdagrad": lambda: opt.DecayedAdagradOptimizer(0.1),
        "Adadelta": lambda: opt.Adadelta(1.0, rho=0.9),
        "RMSProp": lambda: opt.RMSProp(0.01, momentum=0.5),
        "Ftrl": lambda: opt.FtrlOptimizer(0.1, l1=0.01, l2=0.01),
        "Ftrl_power": lambda: opt.Ftrl(0.1, lr_power=-0.7),
        "L1Decay": lambda: opt.Momentum(
            0.05, momentum=0.9, regularization=reg.L1Decay(0.01)),
        "L2Decay": lambda: opt.SGDOptimizer(
            0.1, regularization=reg.L2DecayRegularizer(0.05)),
    }[kind]()


CLIPS = {"ClipByValue": lambda c: c.GradientClipByValue(0.02),
         "ClipByNorm": lambda c: c.GradientClipByNorm(0.05),
         "ClipByGlobalNorm": lambda c: c.GradientClipByGlobalNorm(0.1)}


def _build_net(pkg, kind, clip=None):
    fw, layers = pkg[0], pkg[1]
    prog, startup = fw.Program(), fw.Program()
    prog.random_seed = startup.random_seed = 7
    with fw.program_guard(prog, startup), fw.unique_name.guard():
        x = layers.data(name="x", shape=[B, DIN], dtype="float32",
                        append_batch_size=False)
        y = layers.data(name="y", shape=[B, 1], dtype="float32",
                        append_batch_size=False)
        h = layers.fc(x, H, act="relu")
        err = layers.elementwise_sub(layers.fc(h, 1), y)
        loss = layers.mean(layers.square(err))
        if clip is not None:
            pkg[3].set_gradient_clip(CLIPS[clip](pkg[3]), program=prog)
        _opt(pkg, kind).minimize(loss)
    return prog, startup, loss


def _carry(jprog, jstart):
    """The JAX startup's state: (JAX scope, port scope with its copy)."""
    exe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(jstart)
    names = [v.name for v in jprog.list_vars() if v.persistable]
    pscope = pt.Scope()
    for name, val in pt_io.state_from_numpy(
            {n: np.asarray(jscope.find_var(n)) for n in names},
            pt.CPUPlace()).items():
        pscope.set_var(name, val)
    return exe, jscope, pscope, names


def _feed(step):
    r = np.random.RandomState(100 + step)
    return {"x": r.standard_normal((B, DIN)).astype(np.float32),
            "y": r.standard_normal((B, 1)).astype(np.float32)}


def _close(pscope, jscope, names):
    for name in names:
        np.testing.assert_allclose(
            pscope.find_var(name).numpy(),
            np.asarray(jscope.find_var(name)).astype(
                pscope.find_var(name).numpy().dtype),
            rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind, clip", [
    (k, None) for k in ("SGD", "Momentum", "Momentum_nesterov", "Adagrad",
                        "Adam", "Adamax", "DecayedAdagrad", "Adadelta",
                        "RMSProp", "Ftrl", "Ftrl_power", "L1Decay",
                        "L2Decay")] + [("SGD", c) for c in CLIPS])
def test_optimizer_trains_as_the_jax_package_does(kind, clip):
    jprog, jstart, jloss = _build_net(JAX, kind, clip)
    pprog, pstart, ploss = _build_net(PORT, kind, clip)
    assert pprog.to_json() == jprog.to_json()
    assert pstart.to_json() == jstart.to_json()
    exe, jscope, pscope, names = _carry(jprog, jstart)
    pexe = pt.Executor(pt.CPUPlace())
    for step in range(3):
        with fluid.scope_guard(jscope):
            (want,) = exe.run(jprog, feed=_feed(step),
                              fetch_list=[jloss.name])
        (got,) = pexe.run(pprog, feed=_feed(step), fetch_list=[ploss.name],
                          scope=pscope)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _close(pscope, jscope, names)


def test_every_optimizer_class_and_alias_is_exported():
    assert set(pt_optimizer.__all__) == set(jax_optimizer.__all__)
    for name in jax_optimizer.__all__:
        assert getattr(pt_optimizer, name).__name__ == \
            getattr(jax_optimizer, name).__name__, name


def _build_average(pkg):
    prog, startup, loss = _build_net(pkg, "SGD")
    with pkg[0].program_guard(prog, startup), pkg[0].unique_name.guard(
            "ma"):
        avg = pkg[2].ModelAverage(0.15, min_average_window=2,
                                  max_average_window=10)
    return prog, startup, loss, avg


def test_model_average_apply_and_restore_match_jax():
    jprog, jstart, jloss, javg = _build_average(JAX)
    pprog, pstart, ploss, pavg = _build_average(PORT)
    assert pprog.to_json() == jprog.to_json()
    exe, jscope, pscope, names = _carry(jprog, jstart)
    pexe = pt.Executor(pt.CPUPlace())
    params = [p.name for p in jprog.all_parameters()]
    for step in range(3):
        with fluid.scope_guard(jscope):
            exe.run(jprog, feed=_feed(step), fetch_list=[jloss.name])
        pexe.run(pprog, feed=_feed(step), fetch_list=[ploss.name],
                 scope=pscope)
    _close(pscope, jscope, names)
    before = {n: pscope.find_var(n).clone() for n in params}
    held = {n: pscope.find_var(n) for n in params}
    with fluid.scope_guard(jscope):
        javg.apply(exe)
    with pt.scope_guard(pscope):
        pavg.apply(pexe)
    for n in params:
        assert pscope.find_var(n) is held[n]   # written in place
    _close(pscope, jscope, params)
    assert any(not torch.equal(before[n], held[n]) for n in params)
    with fluid.scope_guard(jscope):
        javg.restore(exe)
    with pt.scope_guard(pscope):
        pavg.restore(pexe)
    for n in params:
        assert torch.equal(pscope.find_var(n), before[n]), n
    # the next step reads the restored values
    with fluid.scope_guard(jscope):
        (want,) = exe.run(jprog, feed=_feed(3), fetch_list=[jloss.name])
    (got,) = pexe.run(pprog, feed=_feed(3), fetch_list=[ploss.name],
                      scope=pscope)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close(pscope, jscope, names)
