"""The port's training surface against the JAX package's, on the CPU: LR
schedulers, ``cross_entropy``'s options, the loss scaler in and out of the
train step, ``run_steps``, the recompute policies, RMSNorm's layers and
functionals, and ``amp.decorate``.

Inputs are numpy arrays from a fixed seed, handed to both sides. Models
are ``gpt_tiny(num_kv_heads=2)`` with random numpy weights converted by
``paddle_tpu_torch.weights``, as ``tests/test_torch_training.py`` builds
them; the port runs its plain kernel versions on the CPU. Everything is
fp32, where the two sides agree to summation order.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet import (make_sharded_train_step,
                                                recompute)
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.weights import from_paddle_tpu

B, S = 4, 32
LOSS_TOL = 1e-5   # fp32 loss ~6 through two blocks: summation order only
PARAM_TOL = 3e-5  # 1% of three AdamW steps' largest move at lr 1e-3


def _build(**over):
    """(JAX model, port model) with the same random weights."""
    paddle.seed(0)
    jm = gpt_tiny(num_kv_heads=2, dropout=0.0, **over)
    rng = np.random.default_rng(0)
    params = {}
    for name, v in jm.functional_state()[0].items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = 0.2 * rng.standard_normal(shape)
        elif "bias" in name:
            a = 0.05 * rng.standard_normal(shape)
        else:
            a = 1 + 0.1 * rng.standard_normal(shape)
        params[name] = a.astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    tm = GPTForCausalLM(GPTConfig(**{**GPT_TINY, "num_kv_heads": 2,
                                     "dropout": 0.0, **over}), device="cpu")
    tm.load_state_dict(from_paddle_tpu(params))
    return jm, tm


def _batch(seed, k=None):
    shape = (B, S) if k is None else (k, B, S)
    x = np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)
    return x, np.roll(x, -1, axis=-1)


def _assert_params_close(want, tm, steps, lr):
    """Every parameter to ``PARAM_TOL``, but the K third of each qkv bias:
    its true gradient is zero (softmax is shift-invariant along a row), so
    both sides step rounding noise, which Adam moves by up to lr a step;
    there the bound is 2 * steps * lr."""
    D, Hq, Hkv = tm.cfg.head_dim, tm.cfg.num_heads, tm.cfg.num_kv_heads
    for name, p in tm.named_parameters():
        diff = np.abs(np.asarray(want[name]) - p.detach().numpy())
        if name.endswith("attn.qkv.bias"):
            k_part = slice(Hq * D, (Hq + Hkv) * D)
            assert float(diff[k_part].max()) <= 2 * steps * lr, name
            diff[k_part] = 0
        assert float(diff.max()) <= PARAM_TOL, (name, float(diff.max()))


# ---------------- LR schedulers --------------------------------------------
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=1.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.1, decay_steps=10, end_lr=0.001, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, 20), warmup_steps=5, start_lr=0.0,
        end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 9, 20], gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1,
                                                           lambda e: 0.9),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=12, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, factor=0.5,
                                                   patience=2, cooldown=1),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6, mode="triangular2"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    """30 steps of each scheduler: ``last_lr``, ``get_lr()`` and the state
    dict equal the JAX package's (the same Python arithmetic).
    ``ReduceOnPlateau`` steps on a metric that stalls."""
    ours, theirs = SCHEDULERS[name](tlr), SCHEDULERS[name](jlr)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5] * 5
    for i in range(30):
        assert ours.last_lr == theirs.last_lr and ours() == theirs()
        assert ours.get_lr() == theirs.get_lr(), i
        if name == "ReduceOnPlateau":
            ours.step(metrics[i])
            theirs.step(metrics[i])
        else:
            ours.step()
            theirs.step()
    assert repr(ours.state_dict()) == repr(theirs.state_dict())


def test_scheduler_base_class_has_no_schedule():
    """The 17th class, ``LRScheduler`` itself, raises on both sides."""
    for m in (tlr, jlr):
        with pytest.raises(NotImplementedError):
            m.LRScheduler(0.1)


def test_optimizer_reads_its_scheduler():
    """``get_lr()`` follows the attached scheduler on both sides, and
    ``set_lr`` refuses while one is attached; a float learning rate can be
    set."""
    ts, js = tlr.StepDecay(0.1, 2), jlr.StepDecay(0.1, 2)
    topt = AdamW(learning_rate=ts)
    jopt = paddle.optimizer.AdamW(learning_rate=js)
    for _ in range(5):
        assert topt.get_lr() == jopt.get_lr()
        ts.step()
        js.step()
    for opt in (topt, jopt):
        with pytest.raises(RuntimeError, match="LRScheduler"):
            opt.set_lr(0.5)
    plain = AdamW(learning_rate=0.1)
    plain.set_lr(0.5)
    assert plain.get_lr() == 0.5


def test_adamw_lr_ratio_scales_each_parameters_rate():
    """``lr_ratio(name)`` multiplies that parameter's learning rate: a ratio
    of 0.5 gives the update of half the rate, exactly."""
    rng = np.random.default_rng(1)
    w0, g = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2))
    out = {}
    for key, kw in (("ratio", dict(learning_rate=1e-2,
                                   lr_ratio=lambda n: 0.5)),
                    ("half", dict(learning_rate=5e-3))):
        p = torch.from_numpy(w0.copy())
        p.grad = torch.from_numpy(g)
        AdamW(parameters={"w": p}, **kw).step()
        out[key] = p
    assert torch.equal(out["ratio"], out["half"])


# ---------------- cross_entropy options ------------------------------------
CE_CASES = {
    "soft": dict(soft_label=True),
    "soft_smooth": dict(soft_label=True, label_smoothing=0.1),
    "soft_weight": dict(soft_label=True, weight=True),
    "hard_smooth_ignore": dict(label_smoothing=0.2, ignore=True),
    "hard_weight_ignore": dict(weight=True, ignore=True),
    "no_softmax": dict(use_softmax=False),
    "axis0_soft": dict(soft_label=True, axis=0),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_options_match_jax(case, reduction):
    """Soft labels, label smoothing, class weights, ``use_softmax=False``
    and another axis against the JAX package: each value to 1e-6 of the
    larger of 1 and its magnitude (fp32 log-softmax, summation order)."""
    spec = dict(CE_CASES[case])
    rng = np.random.default_rng(13)
    C, N = 7, 12
    axis = spec.pop("axis", -1)
    logits = (2 * rng.standard_normal((N, C))).astype(np.float32)
    if not spec.get("use_softmax", True):
        logits = rng.dirichlet(np.ones(C), N).astype(np.float32)
    if spec.get("soft_label"):
        labels = rng.dirichlet(np.ones(C), N).astype(np.float32)
    else:
        labels = rng.integers(0, C, N)
        if spec.pop("ignore", False):
            labels[[1, 5]] = -100
    if axis == 0:
        logits, labels = logits.T.copy(), labels.T.copy()
    kw = {k: v for k, v in spec.items() if k != "weight"}
    w = (0.5 + rng.random(C)).astype(np.float32) if spec.get("weight") \
        else None
    want = JF.cross_entropy(Tensor(jnp.asarray(logits)),
                            Tensor(jnp.asarray(labels)), reduction=reduction,
                            axis=axis, weight=None if w is None else
                            Tensor(jnp.asarray(w)), **kw)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           reduction=reduction, axis=axis,
                           weight=None if w is None else torch.from_numpy(w),
                           **kw)
    want = np.asarray(want._value)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(want - got.numpy()).max()) <= \
        1e-6 * max(1.0, float(np.abs(want).max()))


# ---------------- RMSNorm layers and functionals ---------------------------
def _rms_inputs(shape=(2, 5, 48)):
    rng = np.random.default_rng(14)
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w, rng


def test_rms_norm_layer_matches_jax():
    """``nn.RMSNorm`` forward and backward (dx and the weight's gradient)
    against the JAX layer: fp32, 1e-5 of the larger of 1 and the
    magnitude."""
    x, w, rng = _rms_inputs()
    g = rng.standard_normal(x.shape).astype(np.float32)
    jl = paddle.nn.RMSNorm(48)
    jl.set_state_dict({"weight": paddle.to_tensor(w)})
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jl(jx)
    (jy * paddle.to_tensor(g)).sum().backward()
    tl = RMSNorm(48, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl(tx)
    assert type(ty.grad_fn).__name__ == "RMSNormFunctionBackward"
    ty.backward(torch.from_numpy(g))
    for want, got in ((jy, ty), (jx.grad, tx.grad),
                      (jl.weight.grad, tl.weight.grad)):
        want = want.numpy()
        assert float(np.abs(want - got.detach().numpy()).max()) <= \
            1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("weighted", [True, False], ids=["weight", "no_weight"])
def test_rms_norm_functional_matches_jax(weighted):
    x, w, _ = _rms_inputs()
    want = JF.rms_norm(paddle.to_tensor(x),
                       paddle.to_tensor(w) if weighted else None, 1e-6)
    got = TF.rms_norm(torch.from_numpy(x),
                      torch.from_numpy(w) if weighted else None, 1e-6)
    assert float(np.abs(want.numpy() - got.numpy()).max()) <= 1e-5


@pytest.mark.parametrize("axis,bias", [(-1, False), (-1, True), (-2, True),
                                       (1, False)],
                         ids=["last", "last_bias", "two_axes_bias", "axis1"])
def test_incubate_fused_rms_norm_matches_jax(axis, bias):
    """``incubate.nn.functional.fused_rms_norm`` over the last axis (the
    kernel's path) and over several trailing axes (``begin_norm_axis`` -2
    and 1, the plain multi-axis arithmetic), with and without
    ``norm_bias``."""
    from paddle_tpu.incubate.nn.functional import fused_rms_norm as j_fused

    x, _, rng = _rms_inputs()
    wshape = x.shape[axis % x.ndim:]
    w = (1 + 0.1 * rng.standard_normal(wshape)).astype(np.float32)
    b = (0.1 * rng.standard_normal(wshape[-1:])).astype(np.float32)
    want = j_fused(paddle.to_tensor(x), paddle.to_tensor(w),
                   paddle.to_tensor(b) if bias else None, 1e-6,
                   begin_norm_axis=axis)
    got = TIF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b) if bias else None, 1e-6,
                             begin_norm_axis=axis)
    assert got.shape == x.shape
    assert float(np.abs(want.numpy() - got.numpy()).max()) <= 1e-5


# ---------------- the loss scaler, eager -----------------------------------
@pytest.mark.parametrize("finite", [True, False], ids=["finite", "inf_grad"])
@pytest.mark.parametrize("entry", ["step_update", "minimize"])
def test_grad_scaler_eager_matches_jax(finite, entry):
    """The eager API (``scale``, ``unscale_`` through ``step`` or
    ``minimize``, then ``update``) on one parameter with AdamW: the
    parameter and the scaler's state dict equal the JAX package's; a
    non-finite gradient skips the update and backs the scale off."""
    w0 = np.array([1.0, -2.0, 0.5], np.float32)
    x = np.array([3.0, 1.0, -1.0], np.float32)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=1)
    sides = {}
    for side in ("jax", "port"):
        if side == "jax":
            p = paddle.nn.Parameter(w0.copy())
            opt = paddle.optimizer.AdamW(learning_rate=0.1, parameters=[p])
            scaler = paddle.amp.GradScaler(**kw)
            loss = (p * paddle.to_tensor(x)).sum() * (1.0 if finite
                                                      else float("inf"))
        else:
            p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
            opt = AdamW(learning_rate=0.1, parameters=[p])
            scaler = amp.GradScaler(**kw)
            loss = (p * torch.from_numpy(x)).sum() * (1.0 if finite
                                                      else float("inf"))
        scaled = scaler.scale(loss)
        if entry == "minimize":
            scaler.minimize(opt, scaled)
        else:
            scaled.backward()
            scaler.step(opt)
        scaler.update()
        sides[side] = (np.asarray(p.numpy() if side == "jax"
                                  else p.detach().numpy()),
                       scaler.state_dict())
    (pj, sj), (pt, st) = sides["jax"], sides["port"]
    assert sj == st
    assert np.abs(pj - pt).max() <= 2e-6
    assert np.array_equal(pt, w0) == (not finite)


def test_amp_decorate_and_bf16_support():
    """``decorate(level='O2')`` casts the model to bf16 and gives the
    optimizer fp32 master weights, as the JAX package's does;
    ``auto_cast`` off or at O0 is a no-op."""
    tm = GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu")
    opt = AdamW(parameters=tm.named_parameters())
    out_m, out_o = amp.decorate(tm, opt, level="O2")
    assert out_m is tm and out_o is opt and opt._multi_precision
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert amp.is_bfloat16_supported("cpu")
    for ctx in (amp.auto_cast(enable=False), amp.auto_cast(level="O0")):
        with ctx:
            pass


# ---------------- the train step with scaler and scheduler -----------------
def _scaled_steps(policy=None):
    """JAX and port train steps with a GradScaler and a LinearWarmup over a
    CosineAnnealingDecay, on the same weights."""
    jm, tm = _build(use_recompute=policy is not None, recompute_policy=policy,
                    loss_chunk=8)
    kw = dict(incr_every_n_steps=2)

    def sched(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(1e-3, 100), 2, 1e-4,
                              1e-3)

    js, ts = sched(jlr), sched(tlr)
    jscaler = paddle.amp.GradScaler(init_loss_scaling=float("inf"), **kw)
    tscaler = amp.GradScaler(init_loss_scaling=float("inf"), **kw)
    jstep = j_make_step(jm, paddle.optimizer.AdamW(
        learning_rate=js, parameters=jm.parameters(), weight_decay=0.01),
        scaler=jscaler)
    tstep = make_sharded_train_step(tm, AdamW(
        learning_rate=ts, parameters=tm.named_parameters(),
        weight_decay=0.01), scaler=tscaler, device="cpu")
    return (jstep, js), (tstep, ts, tscaler), tm


def _automaton(jstep, tscaler):
    j = tuple(float(v) for v in jstep.scaler_state)
    t = (tscaler._scale, float(tscaler._good_steps),
         float(tscaler._bad_steps))
    return j, t


@pytest.mark.parametrize("policy", [None, "save_flash"],
                         ids=["no_recompute", "save_flash"])
def test_scaled_train_step_with_scheduler_matches_jax(policy):
    """3 steps with a loss scaler and a scheduler. Step 1 overflows on both
    sides (an infinite scale: no finite fp32 scale overflows these fp32
    gradients, the largest of which is ~0.2): it is skipped, parameters and
    optimizer state stay bitwise as they were, and the automaton advances
    equally. The scale is then reset to 2^10 on both sides; steps 2 and 3
    train at the scheduler's rates, and the second good step doubles the
    scale. Losses to 1e-5, parameters to 3e-5, the automaton equal after
    every step."""
    (jstep, js), (tstep, ts, tscaler), tm = _scaled_steps(policy)
    p0 = {k: p.detach().clone() for k, p in tm.named_parameters()}
    j0 = {k: np.asarray(v) for k, v in jstep.params.items()}
    s0 = {k: {n: (v.clone() if torch.is_tensor(v) else v)
              for n, v in s.items()} for k, s in tstep.optimizer.state.items()}
    x, y = _batch(20)
    lj, lt = float(jstep(x, y)), float(tstep(x, y))
    assert not math.isfinite(lj) and not math.isfinite(lt)
    assert all(torch.equal(p0[k], p) for k, p in tm.named_parameters())
    assert all(np.array_equal(j0[k], np.asarray(v))
               for k, v in jstep.params.items())
    for k, s in tstep.optimizer.state.items():
        for n, v in s.items():
            assert (torch.equal(v, s0[k][n]) if torch.is_tensor(v)
                    else v == s0[k][n]), (k, n)
    j, t = _automaton(jstep, tscaler)
    assert j == t and t[0] == float("inf")
    jstep.scaler_state = (jnp.float32(2.0 ** 10), *jstep.scaler_state[1:])
    tscaler.set_init_loss_scaling(2.0 ** 10)
    for i in (1, 2):
        js.step()
        ts.step()
        assert jstep.optimizer.get_lr() == tstep.optimizer.get_lr()
        x, y = _batch(20 + i)
        lj, lt = float(jstep(x, y)), float(tstep(x, y))
        assert abs(lj - lt) <= LOSS_TOL
        j, t = _automaton(jstep, tscaler)
        assert j == t
    assert t == (2.0 ** 11, 0.0, 0.0)
    _assert_params_close(jstep.params, tm, 2, 1e-3)


# ---------------- run_steps ------------------------------------------------
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaler"])
def test_run_steps_equals_k_calls_and_jax(scaled):
    """``run_steps`` over K = 3 stacked batches: losses and parameters equal
    three calls bit for bit, and match JAX ``run_steps`` (losses 1e-5,
    parameters 3e-5). One learning rate serves all K steps."""
    xs, ys = _batch(30, k=3)
    sc = (lambda m: m.GradScaler(init_loss_scaling=2.0 ** 10)) if scaled \
        else (lambda m: None)
    jm, tm = _build(loss_chunk=8)
    _, tm2 = _build(loss_chunk=8)
    # epsilon 1e-6: where a gradient is at rounding level, Adam's
    # m / sqrt(v) would turn its summation-order noise into a full step
    jstep = j_make_step(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, epsilon=1e-6, parameters=jm.parameters()),
        scaler=sc(paddle.amp))
    steps = [make_sharded_train_step(m, AdamW(
        learning_rate=1e-3, epsilon=1e-6, parameters=m.named_parameters()),
        scaler=sc(amp), device="cpu") for m in (tm, tm2)]
    want = np.asarray(jstep.run_steps(xs, ys))
    got = steps[0].run_steps(xs, ys)
    calls = torch.stack([steps[1](xs[k], ys[k]) for k in range(3)])
    assert got.shape == (3,) and torch.equal(got, calls)
    assert steps[0]._step_i == 3
    for (k, p), q in zip(tm.named_parameters(), tm2.parameters()):
        assert torch.equal(p, q), k
    assert np.abs(want - got.numpy()).max() <= LOSS_TOL
    _assert_params_close(jstep.params, tm, 3, 1e-3)
    assert steps[0].loss_scaling() == jstep.loss_scaling()


# ---------------- recompute policies ---------------------------------------
@pytest.mark.parametrize("policy", ["full", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable",
                                    "save_flash"])
def test_recompute_policy_keeps_loss_and_grads(policy, monkeypatch):
    """Every policy computes the loss and gradients of the model without
    recompute, bit for bit on the CPU (policies trade memory for replayed
    work, never numerics), with the chunked loss's own checkpoint beside
    the blocks'. Flash forwards per step: two per block under full
    recompute and the dots policies (the replay runs the kernel again),
    one under ``save_flash`` (O and LSE are kept)."""
    kfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    calls = []
    real = kfa.flash_attention_fwd
    monkeypatch.setattr(kfa, "flash_attention_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, y = (torch.from_numpy(a).long() for a in _batch(40))
    out = {}
    for pol in (None, policy):
        _, tm = _build(use_recompute=pol is not None, recompute_policy=pol,
                       loss_chunk=8)
        calls.clear()
        loss = tm.forward_with_loss(x, y)
        loss.backward()
        out[pol] = (loss.detach(), {k: p.grad for k, p in
                                    tm.named_parameters()}, len(calls))
    (l0, g0, n0), (l1, g1, n1) = out[None], out[policy]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    L = GPT_TINY["num_layers"]
    assert n0 == L and n1 == (L if policy == "save_flash" else 2 * L)


def test_recompute_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(torch.sin, torch.zeros(2), policy="dots")


def test_recompute_policy_matches_jax_model():
    """The JAX model with ``save_flash`` and the port's: the same loss and
    first-layer gradient (fp32, summation order), as
    ``tests/test_gpt_model.py`` holds the JAX policies to each other."""
    jm, tm = _build(use_recompute=True, recompute_policy="save_flash")
    x, y = _batch(41)
    jl = jm.loss(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    jl.backward()
    tl = tm.loss(tm(torch.from_numpy(x).long()), torch.from_numpy(y).long())
    tl.backward()
    assert abs(float(jl.numpy()) - tl.item()) <= LOSS_TOL
    name = "gpt.layers.0.mlp.fc1.weight"
    want = dict(jm.named_parameters())[name].grad.numpy()
    got = dict(tm.named_parameters())[name].grad.numpy()
    assert np.abs(want - got).max() <= 1e-5


# ---------------- recompute's keywords (ROADMAP C3) -------------------------
@pytest.mark.parametrize("kw", [dict(use_reentrant=False),
                                dict(use_reentrant=True),
                                dict(preserve_rng_state=False),
                                dict(use_reentrant=False,
                                     preserve_rng_state=True,
                                     policy="dots_saveable")])
def test_recompute_takes_the_reference_keywords(kw):
    """``recompute(block, x, use_reentrant=..., preserve_rng_state=...)``
    as paddle model code calls it: the same output and gradients as the
    block run plainly, bit for bit on the CPU; ``recompute_sequential``
    and ``recompute_hybrid`` take the same keywords."""
    from paddle_tpu_torch.distributed.fleet import (recompute_hybrid,
                                                    recompute_sequential)

    _, tm = _build()
    block = tm.gpt.layers[0]
    x = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (B, S, GPT_TINY["hidden_size"])).astype(np.float32))
    outs = []
    for run in (lambda h: block(h), lambda h: recompute(block, h, **kw),
                lambda h: recompute_hybrid({}, block, h, **kw),
                lambda h: recompute_sequential({}, [block], h, **kw)):
        h = x.clone().requires_grad_(True)
        tm.zero_grad()
        out = run(h)
        out.square().sum().backward()
        outs.append((out.detach(), h.grad, block.mlp.fc1.weight.grad.clone()))
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], got))


# ---------------- the reference's signatures (ROADMAP C4) -------------------
def _signature_cases():
    """One case per public callable of ``paddle_tpu_torch`` whose module's
    counterpart in ``paddle_tpu`` defines the same name (classes by their
    constructor and by each public method both define), deduplicated over
    re-exports."""
    import inspect
    import pkgutil

    import paddle_tpu_torch

    cases, seen = [], set()
    mods = [paddle_tpu_torch.__name__] + [
        m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch.")
        if "._" not in m.name]
    for modname in mods:
        port = importlib.import_module(modname)
        try:
            ref = importlib.import_module(
                "paddle_tpu" + modname[len("paddle_tpu_torch"):])
        except ImportError:
            continue
        names = getattr(port, "__all__", None) or [
            n for n, v in vars(port).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == modname]
        for n in names:
            obj, robj = getattr(port, n, None), getattr(ref, n, None)
            if (not callable(obj) or not callable(robj)
                    or inspect.ismodule(obj)
                    or not getattr(obj, "__module__", "").startswith(
                        "paddle_tpu_torch")):
                continue
            pairs = [(None, obj, robj)]
            if inspect.isclass(obj) and inspect.isclass(robj):
                pairs += [(a, v, getattr(robj, a)) for a, v in vars(obj).items()
                          if not a.startswith("_") and inspect.isfunction(v)
                          and callable(getattr(robj, a, None))]
            for attr, p, r in pairs:
                key = (id(p), id(r))
                if key in seen:
                    continue
                seen.add(key)
                label = f"{obj.__module__}.{n}" + (f".{attr}" if attr else "")
                cases.append(pytest.param(obj, robj, attr, id=label))
    return cases


#: the one exception: the JAX package's functional ``apply_gradients(params,
#: grads, state, lr, step_count)`` became in-place updates of the named
#: parameters, ``apply_gradients(named_params, lr)``
SIGNATURE_EXCEPTIONS = {"paddle_tpu_torch.optimizer.optimizer.Optimizer"
                        ".apply_gradients": ("self", "named_params", "lr")}


@pytest.mark.parametrize("obj,robj,attr", _signature_cases())
def test_port_takes_the_reference_parameters_first(obj, robj, attr, request):
    """The reference's parameters are the port's first ones, by name and in
    order, each positional where the reference's is; whatever the port adds
    (``device``, ``dtype``, ``generator``) is keyword-only after them, so a
    call written for ``paddle_tpu`` lands every argument where it meant."""
    import inspect

    p = getattr(obj, attr) if attr else obj
    r = getattr(robj, attr) if attr else robj
    label = request.node.callspec.id
    try:
        ref = list(inspect.signature(r).parameters.values())
    except ValueError:  # a builtin's signature (an exception class's)
        with pytest.raises(ValueError):
            inspect.signature(p)
        return
    port = list(inspect.signature(p).parameters.values())
    if label in SIGNATURE_EXCEPTIONS:
        assert tuple(q.name for q in port) == SIGNATURE_EXCEPTIONS[label]
        return
    var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    rnamed = [q for q in ref if q.kind not in var]
    pnamed = [q for q in port if q.kind not in var]
    assert [q.name for q in pnamed[:len(rnamed)]] == [q.name for q in rnamed]
    for rq, pq in zip(rnamed, pnamed):
        if rq.kind != inspect.Parameter.KEYWORD_ONLY:
            assert pq.kind == rq.kind, (rq.name, pq.kind)
    assert all(q.kind == inspect.Parameter.KEYWORD_ONLY
               for q in pnamed[len(rnamed):]), pnamed[len(rnamed):]
    for kind in var:
        if any(q.kind == kind for q in ref):
            assert any(q.kind == kind for q in port), kind


def test_embedding_padding_idx_matches_jax():
    """``Embedding(num, dim, padding_idx)``: the row is zeroed at
    construction, its lookups return zeros and it gets no gradient, as in
    the JAX package (a negative index counts from the end)."""
    from paddle_tpu_torch.nn import Embedding

    for pad in (0, -2):
        jemb = paddle.nn.Embedding(10, 4, pad)
        temb = Embedding(10, 4, pad, device="cpu")
        row = pad % 10
        assert temb.padding_idx == jemb.padding_idx == row
        assert not temb.weight[row].any()
        w = np.random.default_rng(3).standard_normal((10, 4)) \
            .astype(np.float32)
        jemb.weight.set_value(paddle.to_tensor(w))
        with torch.no_grad():
            temb.weight.copy_(torch.from_numpy(w))
        ids = np.array([[row, 1, 2], [3, row, 9]])
        want = jemb(paddle.to_tensor(ids)).numpy()
        got = temb(torch.from_numpy(ids))
        assert np.array_equal(want, got.detach().numpy())
        got.sum().backward()
        assert not temb.weight.grad[row].any()
        assert temb.weight.grad[1].all()
    with pytest.raises(NotImplementedError, match="A8"):
        Embedding(10, 4, sparse=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        Embedding(10, 4, weight_attr=object(), device="cpu")


def test_norm_attrs_and_positional_parallel_linear():
    """``LayerNorm(bias_attr=False)`` builds no bias and computes the JAX
    package's value; ``ColumnParallelLinear(h, n, None, True, False)``
    (paddle's positional order) has a bias; ``fuse_matmul_bias`` is
    stored and changes no value, as in the JAX package; an ``mp_group``
    that is not a ``Group`` raises."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    from paddle_tpu_torch.nn import LayerNorm

    x = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
    jln = paddle.nn.LayerNorm(8, 1e-5, None, False)
    tln = LayerNorm(8, 1e-5, None, False, device="cpu")
    assert tln.bias is None and LayerNorm(8, weight_attr=False,
                                          device="cpu").weight is None
    want = jln(paddle.to_tensor(x)).numpy()
    got = tln(torch.from_numpy(x)).detach().numpy()
    assert np.abs(want - got).max() <= 1e-6
    col = ColumnParallelLinear(8, 24, None, True, False, device="cpu")
    assert col.bias is not None and col.gather_output is False
    fused = ColumnParallelLinear(8, 24, fuse_matmul_bias=True, device="cpu")
    assert fused.fuse_matmul_bias is True
    fused.load_state_dict(col.state_dict())
    with torch.no_grad():
        col.bias.normal_()
        fused.bias.copy_(col.bias)
        xt = torch.from_numpy(x)[None]
        assert torch.equal(col(xt), fused(xt))
    assert RowParallelLinear(24, 8, None, False, device="cpu").bias is None
    for make in (lambda: ColumnParallelLinear(8, 8, mp_group=object()),
                 lambda: VocabParallelEmbedding(8, 4, mp_group=object())):
        with pytest.raises(TypeError, match="mp_group must be a Group"):
            make()


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_layer_takes_paddles_arguments(mode):
    """``Dropout(p, axis, mode)``: kept entries scaled as ``mode`` says,
    the mask shared along the axes not named by ``axis``, and evaluation
    the identity (upscale) or a scale by 1 - p (downscale)."""
    from paddle_tpu_torch.nn import Dropout

    x = torch.ones(64, 32)
    drop = Dropout(0.25, 0, mode)
    torch.manual_seed(0)
    y = drop(x)
    keep = float(np.float32(1 / 0.75)) if mode == "upscale_in_train" \
        else 1.0
    assert set(torch.unique(y).tolist()) <= {0.0, keep}
    assert (y == y[:, :1]).all()  # one draw per row, shared along axis 1
    assert 0 < int((y[:, 0] == 0).sum()) < 64
    y = Dropout(0.25, None, mode)(x)  # one draw per element
    assert set(torch.unique(y).tolist()) == {0.0, keep}
    drop.eval()
    want = x if mode == "upscale_in_train" else x * 0.75
    assert torch.equal(drop(x), want)
    with pytest.raises(ValueError, match="mode"):
        Dropout(0.5, mode="scale")


def test_unported_model_options_raise():
    from paddle_tpu_torch.distributed import PartitionSpec
    from paddle_tpu_torch.models.gpt import GPTBlock

    for over in (dict(sequence_parallel=True),
                 dict(context_parallel="ulysses")):
        with pytest.raises(NotImplementedError, match="A5"):
            GPTConfig(**GPT_TINY, **over)
    # MoE is ported (A5.1): a MoE block builds; so is pipelining (A5.6):
    # the dense model's spec, and the pipeline options on a mesh without
    # pp are read only at pp above 1, as in the JAX step
    assert type(GPTBlock(GPTConfig(**GPT_TINY, moe_num_experts=4), True,
                         device="cpu").mlp).__name__ == "GPTMoEMLP"
    _, tm = _build()
    spec = tm.pipeline_spec()
    assert (spec.block_prefix, spec.n_blocks) == ("gpt.layers", 2)
    opt = AdamW(parameters=tm.named_parameters())
    for kw in (dict(pp_remat=False), dict(virtual_pp_degree=2),
               dict(pp_schedule="gpipe"), dict(pp_schedule="zb")):
        assert make_sharded_train_step(tm, opt, device="cpu",
                                       **kw)._pspec is None
    with pytest.raises(NotImplementedError, match="A5.7"):
        make_sharded_train_step(tm, opt, device="cpu",
                                batch_spec=PartitionSpec(None, "dp"))
    from paddle_tpu_torch.distributed import DeviceMesh

    with pytest.raises(ValueError, match="pp_schedule"):
        make_sharded_train_step(tm, opt, device="cpu", pp_schedule="zb",
                                mesh=DeviceMesh(np.arange(2), ("pp",)))
    with pytest.raises(NotImplementedError, match="A7"):
        make_sharded_train_step(tm, opt, autoshard_fixed_mesh=True,
                                device="cpu")
    from paddle_tpu_torch.distributed.fleet import ShardedTrainStep

    step = ShardedTrainStep(tm, opt, None, None, None, False, 5,
                            device="cpu")
    assert step._seed == 5 and step._donate is False
