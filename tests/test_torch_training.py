"""The port's training slice against the JAX package's, on the CPU.

Same weights on both sides: a ``gpt_tiny(num_kv_heads=2)`` JAX model with
random numpy weights, converted by ``paddle_tpu_torch.weights`` into the
port's ``GPTForCausalLM``, as ``test_torch_serving.py`` does. The port runs
on the CPU, where every kernel wrapper takes its plain version: flash
attention and LayerNorm go through their ``torch.autograd.Function``s,
whose CPU backward is the backward kernels' arithmetic, and AdamW through
``adamw_ref``. The JAX side runs its own CPU path (``_sdpa_ref`` attention,
the non-fused AdamW arithmetic). Everything is fp32, where the two agree to
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet import (make_sharded_train_step,
                                                recompute)
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.weights import from_paddle_tpu

B, S = 4, 32
# fp32 loss ~6 through two blocks and the head: summation order only
LOSS_TOL = 1e-5
# fp32 gradients of magnitude < 1: summation order only
GRAD_TOL = 1e-5
# parameters after 3 AdamW steps at lr 1e-3: Adam divides by sqrt(v), so a
# gradient's rounding difference moves the update most where the gradient
# is smallest; 3e-5 is 1% of three steps' largest move (3 * lr)
PARAM_TOL = 3e-5


def _build(**over):
    """(JAX model, port model) with the same random weights (std 0.2, wide
    enough that the loss moves visibly in three steps)."""
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
    tm.load_state_dict(from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}))
    return jm, tm


def _batch(seed):
    x = np.random.default_rng(seed).integers(0, 128, (B, S)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


# ---------------- loss and gradients ---------------------------------------
@pytest.mark.parametrize("chunk", [0, 8], ids=["full_logits", "chunk8"])
def test_forward_with_loss_matches_jax(chunk):
    """Loss and every parameter's gradient of ``forward_with_loss``, with
    the chunked cross-entropy off and on (S 32 in chunks of 8)."""
    jm, tm = _build(loss_chunk=chunk)
    x, y = _batch(1)
    pv, bufs = jm.functional_state()

    def f(p):
        with no_grad():
            loss, _ = jm.functional_call(p, bufs, Tensor(jnp.asarray(x)),
                                         Tensor(jnp.asarray(y)),
                                         method="forward_with_loss")
        return loss._value

    import jax

    want_loss, want_grads = jax.value_and_grad(f)(pv)
    loss = tm.forward_with_loss(torch.from_numpy(x).long(),
                                torch.from_numpy(y).long())
    loss.backward()
    assert abs(float(want_loss) - loss.item()) <= LOSS_TOL
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        err = float(np.abs(np.asarray(want_grads[name]) - p.grad.numpy()).max())
        assert err <= GRAD_TOL, (name, err)


def test_chunked_loss_equals_full_loss():
    """The chunked path is the same function as ``loss(forward())``."""
    _, tm = _build(loss_chunk=8)
    x, y = (torch.from_numpy(a).long() for a in _batch(2))
    full = tm.loss(tm(x), y)
    assert abs(tm.forward_with_loss(x, y).item() - full.item()) <= LOSS_TOL


def _grad_fn_names(t):
    names, seen, stack = [], set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


@pytest.mark.parametrize("use_recompute", [False, True],
                         ids=["plain", "recompute"])
def test_grad_fn_names_the_functions(use_recompute, monkeypatch):
    """The autograd graph of the training forward runs through the kernels'
    Functions on the CPU too: one ``flash_fwd`` op node per block and one
    ``LayerNormFunction`` per LayerNorm (two per block and the final one).
    Recompute keeps the graph (non-reentrant checkpoints drop only the
    saved tensors) and replays each block's flash forward in the
    backward: two forwards per block per step."""
    import importlib

    kfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    fwd_calls = []
    real = kfa.flash_attention_fwd
    monkeypatch.setattr(kfa, "flash_attention_fwd",
                        lambda *a, **k: fwd_calls.append(1) or real(*a, **k))
    _, tm = _build(use_recompute=use_recompute)
    x, y = (torch.from_numpy(a).long() for a in _batch(3))
    loss = tm.forward_with_loss(x, y)
    names = _grad_fn_names(loss)
    L = tm.cfg.num_layers
    assert names.count("GeneratedBackwardFor_paddle_tpu_torch_flash_fwd_"
                       "defaultBackward") == L
    assert names.count("LayerNormFunctionBackward") == 2 * L + 1
    loss.backward()
    assert all(p.grad is not None for p in tm.parameters())
    assert len(fwd_calls) == (2 * L if use_recompute else L)


# ---------------- the train step -------------------------------------------
TRAJECTORIES = {
    # recompute, chunked loss, two microbatches (rows m::2), clipping
    "recompute_accum2_clip": dict(
        model=dict(use_recompute=True, loss_chunk=8),
        opt=dict(learning_rate=1e-3, epsilon=1e-6, weight_decay=0.01),
        clip=1.0, accumulate_steps=2),
    # plain forward + loss, no clip, decay only on matrices
    "plain_decay_fun": dict(
        model=dict(), opt=dict(learning_rate=1e-3, weight_decay=0.1),
        clip=None, accumulate_steps=None, decay_fun=True),
}


@pytest.fixture(scope="module", params=sorted(TRAJECTORIES))
def trajectory(request):
    """3 steps of JAX ``make_sharded_train_step`` and of the port's, on the
    same weights and batches; returns (losses JAX, losses port, params JAX,
    port model)."""
    spec = TRAJECTORIES[request.param]
    jm, tm = _build(**spec["model"])
    kw = dict(spec["opt"])
    if spec.get("decay_fun"):
        kw["apply_decay_param_fun"] = lambda n: n.endswith("weight") \
            and "ln" not in n
    jclip = tclip = None
    if spec["clip"]:
        jclip = paddle.nn.ClipGradByGlobalNorm(spec["clip"])
        tclip = ClipGradByGlobalNorm(spec["clip"])
    jstep = j_make_step(jm, paddle.optimizer.AdamW(
        parameters=jm.parameters(), grad_clip=jclip, **kw),
        accumulate_steps=spec["accumulate_steps"])
    tstep = make_sharded_train_step(tm, AdamW(
        parameters=tm.named_parameters(), grad_clip=tclip, **kw),
        accumulate_steps=spec["accumulate_steps"], device="cpu")
    jl, tl = [], []
    for i in range(3):
        x, y = _batch(10 + i)
        jl.append(float(jstep(x, y)))
        tl.append(float(tstep(x, y)))
    assert tstep._step_i == 3
    return jl, tl, {k: np.asarray(v) for k, v in jstep.params.items()}, tm


def test_train_step_losses_match_jax(trajectory):
    jl, tl, _, _ = trajectory
    assert np.abs(np.array(jl) - np.array(tl)).max() <= LOSS_TOL
    assert tl[-1] != tl[0]  # the parameters moved


def test_train_step_params_match_jax(trajectory):
    """Every parameter after step 3, to ``PARAM_TOL``, but for the K third
    of each qkv bias: its true gradient is zero (softmax is shift-invariant
    along a row), so both sides step rounding noise, and Adam moves such an
    entry by up to lr per step in whichever direction the noise points.
    There the two may differ by up to Adam's bound, 2 * 3 * lr."""
    _, _, want, tm = trajectory
    Hq, Hkv = tm.cfg.num_heads, tm.cfg.num_kv_heads
    D = tm.cfg.head_dim
    for name, p in tm.named_parameters():
        diff = np.abs(want[name] - p.detach().numpy())
        if name.endswith("attn.qkv.bias"):
            k_part = slice(Hq * D, (Hq + Hkv) * D)
            assert float(diff[k_part].max()) <= 6e-3, name
            diff[k_part] = 0
        assert float(diff.max()) <= PARAM_TOL, (name, float(diff.max()))


# ---------------- the optimizer --------------------------------------------
OPTIMIZERS = {
    "adamw": (AdamW, paddle.optimizer.AdamW,
              dict(learning_rate=1e-3, weight_decay=0.01), torch.float32),
    "adamw_decay_fun": (AdamW, paddle.optimizer.AdamW,
                        dict(learning_rate=1e-3, weight_decay=0.1,
                             apply_decay_param_fun=lambda n: n == "w"),
                        torch.float32),
    "adamw_amsgrad": (AdamW, paddle.optimizer.AdamW,
                      dict(learning_rate=1e-3, amsgrad=True), torch.float32),
    "adam_l2": (Adam, paddle.optimizer.Adam,
                dict(learning_rate=1e-3, weight_decay=0.01), torch.float32),
    # bench.py's optimizer: fp32 master weights beside bf16 params, bf16
    # moments
    "adamw_master_bf16": (AdamW, paddle.optimizer.AdamW,
                          dict(learning_rate=1e-4, multi_precision=True,
                               moment_dtype="bfloat16"), torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_apply_gradients(case):
    """3 updates of two tensors (one past the TPU kernel's 65536-element
    gate) through the port's in-place ``apply_gradients`` and the JAX
    package's pure one. fp32 state agrees to a few ulps (the port's fused
    AdamW rounds ``1 - lr*wd`` in fp32, the JAX CPU path in double); bf16
    params and moments to one rounding step (bf16 keeps 8 significant bits,
    so a step is at most 2^-7 of the largest value)."""
    ours_cls, jax_cls, kw, dtype = OPTIMIZERS[case]
    rng = np.random.default_rng(7)
    shapes = {"w": (300, 256), "b": (33,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in init.items()}
    tparams = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)))
               .to(dtype) for k, v in jparams.items()}
    jopt, topt = jax_cls(**kw), ours_cls(**kw)
    jstate = jopt.init_state_pytree(jparams)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jg = {k: jnp.asarray(g).astype(jdt) for k, g in grads.items()}
        jparams, jstate = jopt.apply_gradients(jparams, jg, jstate)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(np.asarray(jg[k].astype(jnp.float32))) \
                .to(dtype)
        topt.apply_gradients(tparams)
    for k, p in tparams.items():
        pairs = [(jparams[k], p)] + [
            (jstate[k][slot], topt.state[k][slot])
            for slot in ("moment1", "moment2", "master_weight", "moment2_max")
            if slot in jstate[k]]
        for want, got in pairs:
            assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                                 else torch.float32)
            want = np.asarray(want.astype(jnp.float32))
            tol = 2 ** -7 * float(np.abs(want).max()) \
                if got.dtype == torch.bfloat16 else 2e-6
            assert float(np.abs(want - got.float().numpy()).max()) <= tol
        assert float(jstate[k]["beta1_pow"]) == float(
            topt.state[k]["beta1_pow"])


@pytest.mark.parametrize("case", ["fp32", "bf16_master"])
def test_apply_gradients_updates_in_place(case):
    """``apply_gradients`` writes the parameter where it lies (and, with
    master weights, the fp32 master, which the bf16 parameter then copies),
    equal to ``adamw_ref`` on the same tensors."""
    from paddle_tpu_torch.kernels import adamw_ref

    dtype = torch.bfloat16 if case == "bf16_master" else torch.float32
    rng = np.random.default_rng(8)
    w0 = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    a = w0.to(dtype, copy=True)
    a.grad = g.to(dtype)
    ptr = a.data_ptr()
    opt = AdamW(learning_rate=1e-2, multi_precision=True)
    opt.apply_gradients({"a": a})
    s = opt.state["a"]
    want = adamw_ref(w0.to(dtype).float() if dtype == torch.bfloat16 else w0,
                     g.to(dtype), torch.zeros(8, 4), torch.zeros(8, 4),
                     lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=0.01, beta1_pow=0.9, beta2_pow=0.999)
    assert a.data_ptr() == ptr and a.dtype == dtype
    master = s.get("master_weight", a)
    assert master.dtype == torch.float32 and torch.equal(master, want[0])
    assert torch.equal(a, want[0].to(dtype))
    assert torch.equal(s["moment1"], want[1])
    assert torch.equal(s["moment2"], want[2])


@pytest.mark.parametrize("norm", [0.5, 50.0], ids=["unclipped", "clipped"])
def test_clip_matches_jax(norm):
    """``ClipGradByGlobalNorm.clip_`` over fp32 and bf16 gradients, in
    place: the squared norm summed in fp32, each gradient scaled and cast
    back."""
    rng = np.random.default_rng(9)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (11,))]
    scale = norm / np.sqrt(sum((g ** 2).sum() for g in gs))
    gs = [g * scale for g in gs]
    want = paddle.nn.ClipGradByGlobalNorm(1.0)(
        [(None, Tensor(jnp.asarray(gs[0]))),
         (None, Tensor(jnp.asarray(gs[1]).astype(jnp.bfloat16)))])
    got = [torch.from_numpy(gs[0]), torch.from_numpy(gs[1]).to(torch.bfloat16)]
    ClipGradByGlobalNorm(1.0).clip_(got)
    assert got[1].dtype == torch.bfloat16
    for (_, w), t in zip(want, got):
        w = np.asarray(w._value.astype(jnp.float32))
        tol = 1e-6 if t.dtype == torch.float32 else 2 ** -8 * np.abs(w).max()
        assert float(np.abs(w - t.float().numpy()).max()) <= tol


# ---------------- loss functional and unported options ---------------------
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore", [False, True], ids=["all", "ignore"])
def test_cross_entropy_matches_jax(reduction, ignore):
    rng = np.random.default_rng(11)
    logits = (3 * rng.standard_normal((12, 17))).astype(np.float32)
    labels = rng.integers(0, 17, 12)
    if ignore:
        labels[[1, 5, 6]] = -100
    want = JF.cross_entropy(Tensor(jnp.asarray(logits)),
                            Tensor(jnp.asarray(labels)), reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           reduction=reduction)
    want = np.asarray(want._value)
    assert got.shape == want.shape
    assert float(np.abs(want - got.numpy()).max()) <= 1e-5


@pytest.mark.parametrize("call", [
    lambda: amp.auto_cast(),
    lambda: amp.auto_cast(level="O2", dtype="bfloat16"),
    lambda: amp.amp_guard(level="O1"),
], ids=["auto_cast_O1", "auto_cast_O2", "amp_guard"])
def test_unported_options_raise(call):
    """``auto_cast`` casts each op's inputs at a dispatch seam the port
    does not have yet; it raises instead of running uncast."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 3"):
        call()


@pytest.mark.parametrize("call,exc", [
    (lambda: recompute(torch.sin, torch.zeros(2), policy="dots"), ValueError),
    (lambda: AdamW(learning_rate=object()), TypeError),
], ids=["unknown_policy", "lr_not_a_number"])
def test_bad_arguments_raise(call, exc):
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("option", ["mesh", "grad_reduce", "health_stats",
                                    "param_specs", "autoshard"])
def test_train_step_options_of_later_slices_raise(option):
    """What the port does not cover yet raises: a mesh with a sequence
    (``sep``) axis (a pipeline axis is ported since A5.6), health
    statistics, per-parameter specs it cannot realise and the layout
    search. A gradient reducer is ported: a value that names none raises
    ``TypeError``, as in the JAX package."""
    from paddle_tpu_torch.distributed import DeviceMesh

    _, tm = _build()
    opt = AdamW(parameters=tm.named_parameters())
    value = True if option in ("health_stats", "autoshard") else object()
    if option == "mesh":
        value = DeviceMesh([0, 1], ("sep",))
    err, match = (TypeError, "grad_reduce must be") \
        if option == "grad_reduce" else (NotImplementedError, "ROADMAP")
    with pytest.raises(err, match=match):
        make_sharded_train_step(tm, opt, device="cpu", **{option: value})
