"""The port's GPT-MoE (gates, ``moe_route``, ``MoELayer``, ``GPTMoEMLP``,
the MoE GPT's loss, train step and serving) against the JAX package's, on
the CPU.

Same weights on both sides: one ``gpt_moe_tiny`` JAX model (4 experts, the
MoE FFN in block 1) with random numpy weights (std 0.2, so greedy decoding
does not collapse onto one token), converted by
``paddle_tpu_torch.weights.from_paddle_tpu``. The JAX side routes through
its dense one-hot ``[T, E, C]`` einsums, the port through its index form;
everything is fp32 but the bf16 ``GPTMoEMLP`` case, and the two agree to
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.fleet.utils import \
    make_sharded_train_step as j_make_step
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe.moe_layer import \
    moe_route as j_moe_route
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.incubate.distributed.models.moe.gate import _route
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import \
    moe_route
from paddle_tpu_torch.models import GPTConfig, GPTMoEMLP, gpt_moe_tiny
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.weights import expected_names, from_paddle_tpu

B, S = 4, 32
# fp32 combine weights and aux: the softmax's and the means' summation
# order only
GATE_TOL = 1e-6
# fp32 outputs and gradients of magnitude < 10 through a few products:
# summation order only
TOL = 1e-5
# bf16 expert products (the port's and XLA's CPU GEMMs round alike, but
# may sum in another order): one rounding step of the largest output
BF16_STEP = 2 ** -7
# parameters after 3 AdamW steps at lr 1e-3 (as tests/test_torch_training)
PARAM_TOL = 3e-5
LR = 1e-3


def _params(jm, seed=0):
    """Random numpy weights for every parameter of ``jm``, set into it."""
    rng = np.random.default_rng(seed)
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
    return params


def _jax_model(**over):
    paddle.seed(0)
    jm = jgpt.gpt_moe_tiny(dropout=0.0, **over)
    return jm, _params(jm)


def _port_model(params, **over):
    tm = gpt_moe_tiny(dropout=0.0, device="cpu", **over)
    tm.load_state_dict(from_paddle_tpu(params))
    return tm


@pytest.fixture(scope="module")
def moe_models():
    """One JAX ``gpt_moe_tiny`` (eval mode) and its converted weights."""
    jm, params = _jax_model()
    jm.eval()
    return jm, params


def _batch(seed):
    x = np.random.default_rng(seed).integers(0, 128, (B, S)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# ---------------- the gates -------------------------------------------------
@pytest.mark.parametrize("fill", ["tight", "loose"])
@pytest.mark.parametrize("E", [4, 8])
@pytest.mark.parametrize("T", [16, 37])
@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_gating_matches_jax(gate, T, E, fill):
    """The dense triple from the port's index routing against the
    reference's one-hot gate on the same fp32 logits: ``dispatch``
    bitwise, ``combine`` and ``aux`` within ``GATE_TOL``; a tight capacity
    drops choices, a loose one none."""
    logits = np.random.default_rng(T * E).standard_normal((T, E)) \
        .astype(np.float32)
    C = max(1, T // (2 * E)) if fill == "tight" else T
    jfn = jmoe.gshard_gating if gate == "gshard" else jmoe.switch_gating
    tfn = tmoe.gshard_gating if gate == "gshard" else tmoe.switch_gating
    want = [np.asarray(a) for a in jfn(jnp.asarray(logits), C)]
    got = [a.numpy() for a in tfn(torch.from_numpy(logits), C)]
    assert got[0].shape == (T, E, C) and got[0].dtype == np.float32
    assert np.array_equal(got[0], want[0])
    assert _err(got[1], want[1]) <= GATE_TOL
    assert abs(float(got[2]) - float(want[2])) <= GATE_TOL
    k = 2 if gate == "gshard" else 1
    routed = got[0].sum()
    assert routed < T * k if fill == "tight" else routed == T * k


def test_route_slots_are_the_dense_dispatch():
    """``_route``'s slots are the dense dispatch's nonzeros: each kept
    choice at ``e * C + pos``, a dropped one at ``E * C``."""
    T, E, C = 37, 4, 5
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (T, E)).astype(np.float32))
    slots, weights, _ = _route(logits, C, 2)
    dispatch, combine, _ = tmoe.gshard_gating(logits, C)
    for t in range(T):
        kept = sorted(s for s in slots[t].tolist() if s < E * C)
        assert kept == np.flatnonzero(dispatch[t].reshape(-1)).tolist()
    assert ((slots == E * C) == (weights == 0)).all()
    assert torch.equal(combine.reshape(T, -1).sum(1), weights.sum(1))


# ---------------- moe_route -------------------------------------------------
def _route_inputs(seed, T=40, d=16, f=32, E=4):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((T, d)), 0.5 * rng.standard_normal((d, E)),
        0.3 * rng.standard_normal((E, d, f)),
        0.3 * rng.standard_normal((E, f, d)), rng.standard_normal((T, d)))]


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_route_forward_and_grads_match_jax(gate):
    """``out`` and ``aux`` of ``moe_route``, and the gradients of
    ``sum(out * cot) + 0.3 aux`` with respect to ``x``, the gate weight
    and both expert weights, against ``jax.grad`` through the reference's
    einsum routing (capacity 8 of 40 tokens over 4 experts: drops)."""
    x, gw, w1, w2, cot = _route_inputs(3)
    C = 8

    def j_loss(xv, gwv, w1v, w2v):
        def run(ein):
            h = jnp.tanh(jnp.einsum("ecd,edf->ecf", ein._value, w1v))
            return Tensor(jnp.einsum("ecf,efd->ecd", h, w2v))

        with no_grad():
            out, aux = j_moe_route(Tensor(xv), Tensor(gwv), gate, C, run)
        out, aux = out._value, aux._value
        return (out * cot).sum() + 0.3 * aux, (out, aux)

    (_, (wout, waux)), wgrads = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, gw, w1, w2)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, gw, w1, w2)]

    def run(ein):
        return torch.einsum("ecf,efd->ecd", torch.tanh(
            torch.einsum("ecd,edf->ecf", ein, ts[2])), ts[3])

    out, aux = moe_route(ts[0], ts[1], gate, C, run)
    ((out * torch.from_numpy(cot)).sum() + 0.3 * aux).backward()
    assert _err(out.detach(), wout) <= TOL
    assert abs(aux.item() - float(waux)) <= GATE_TOL
    for name, t, w in zip(("x", "gate_weight", "w1", "w2"), ts, wgrads):
        assert t.grad is not None and t.grad.abs().max() > 0, name
        assert _err(t.grad, w) <= TOL, (name, _err(t.grad, w))


class _Recorder(TorchDispatchMode):
    """Every op's name and every output's shape."""

    def __init__(self):
        super().__init__()
        self.ops, self.shapes = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(str(func))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


def test_moe_route_builds_no_tec_tensor_and_reads_nothing_on_the_host():
    """The forward and backward of ``GPTMoEMLP``'s route make no tensor
    of ``T * E * C`` elements and call no op that reads the device on the
    host (``item``, ``nonzero``)."""
    cfg = GPTConfig(vocab_size=128, hidden_size=16, num_layers=2,
                    num_heads=2, intermediate_size=24, moe_num_experts=4)
    mlp = GPTMoEMLP(cfg, device="cpu")
    with torch.no_grad():
        for p in mlp.parameters():
            p.normal_(0, 0.3)
    x = torch.randn(2, 24, 16, requires_grad=True)
    T, E = 48, 4
    C = max(1, int(1.25 * T / E))
    with _Recorder() as rec:
        mlp(x).sum().backward()
    assert x.grad is not None and mlp.w1.grad is not None
    assert not [s for s in rec.shapes if int(np.prod(s)) == T * E * C], \
        rec.shapes
    host = [op for op in rec.ops
            if any(k in op for k in ("item", "_local_scalar", "nonzero"))]
    assert not host, host


# ---------------- modules ---------------------------------------------------
def _moe_cfg(**over):
    return dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=48, moe_num_experts=4, dropout=0.0, **over)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt_moe_mlp_matches_jax(dtype):
    """``GPTMoEMLP`` (experts in the activation dtype, tanh GELU) on the
    same weights and input: output and aux. fp32 to ``TOL``; bf16 within
    one rounding step of the largest output (routing is the same: the
    bf16 gate logits agree)."""
    paddle.seed(0)
    jl = jgpt.GPTMoEMLP(jgpt.GPTConfig(**_moe_cfg()))
    tl = GPTMoEMLP(GPTConfig(**_moe_cfg()), device="cpu")
    rng = np.random.default_rng(5)
    for name, p in jl.named_parameters():
        a = (0.3 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        p.set_value(paddle.to_tensor(a))
        getattr(tl, name).data.copy_(torch.from_numpy(a))
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    if dtype == "bfloat16":
        jl = jl.astype("bfloat16")
        tl = tl.to(torch.bfloat16)
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    with no_grad():
        want = np.asarray(jl(Tensor(xj))._value.astype(jnp.float32))
    got = tl(xt).detach().float().numpy()
    tol = TOL if dtype == "float32" else BF16_STEP * np.abs(want).max()
    assert got.shape == want.shape
    assert _err(got, want) <= tol, (_err(got, want), tol)
    assert abs(tl.aux_loss.item() - float(jl.aux_loss._value)) <= GATE_TOL


def _expert_pair(widths, act="gelu"):
    paddle.seed(0)
    jl = jmoe.MoELayer(16, [jmoe.ExpertMLP(16, w, act) for w in widths],
                       gate="gshard", capacity_factor=1.0)
    tl = tmoe.MoELayer(16, [tmoe.ExpertMLP(16, w, act, device="cpu")
                            for w in widths], gate="gshard",
                       capacity_factor=1.0, device="cpu")
    rng = np.random.default_rng(7)
    tparams = dict(tl.named_parameters())
    jparams = dict(jl.named_parameters())
    assert set(jparams) == set(tparams)
    for name, p in jparams.items():
        a = (0.4 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        p.set_value(paddle.to_tensor(a))
        tparams[name].data.copy_(torch.from_numpy(a))
    return jl, tl


@pytest.mark.parametrize("widths", [(24, 24, 24, 24), (24, 40, 24, 40)],
                         ids=["homogeneous", "mixed"])
def test_moe_layer_matches_jax(widths):
    """``MoELayer`` over ``ExpertMLP``s: one shape (the batched fp32
    product over stacked weights, exact GELU) and two (expert by expert):
    output and aux, and the batched path equal to the per-expert one."""
    jl, tl = _expert_pair(widths)
    x = np.random.default_rng(8).standard_normal((3, 10, 16)) \
        .astype(np.float32)
    with no_grad():
        want = np.asarray(jl(Tensor(jnp.asarray(x)))._value)
    got = tl(torch.from_numpy(x))
    assert got.shape == (3, 10, 16)
    assert _err(got.detach(), want) <= TOL
    assert abs(tl.aux_loss.item() - float(jl.aux_loss._value)) <= GATE_TOL
    assert (tl._fused_experts() is None) == (widths[0] != widths[1])
    if tl._fused_experts() is not None:
        tl._fused_experts = lambda: None  # the per-expert path
        assert _err(tl(torch.from_numpy(x)).detach(), got.detach()) <= TOL


def test_quant_dispatch_routes_as_dense_bitwise():
    """On one device ``dispatch="quant"`` has no exchange to compress:
    ``MoELayer`` and ``GPTMoEMLP`` give the dense mode's output and
    gradients bit for bit, and the JAX package's quant output."""
    jl, tl = _expert_pair((24,) * 4)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 10, 16)).astype(np.float32))
    dense = tl(x)
    tl.dispatch_mode = "quant"
    assert torch.equal(tl(x), dense)
    jl.dispatch_mode = "quant"
    with no_grad():
        want = np.asarray(jl(Tensor(jnp.asarray(x.numpy())))._value)
    assert _err(dense.detach(), want) <= TOL
    outs = []
    for mode in ("dense", "quant"):
        mlp = GPTMoEMLP(GPTConfig(**_moe_cfg(moe_dispatch=mode)),
                        device="cpu")
        with torch.no_grad():
            for i, p in enumerate(mlp.parameters()):
                p.copy_(torch.from_numpy(np.random.default_rng(i)
                                         .standard_normal(tuple(p.shape))
                                         .astype(np.float32)) * 0.3)
        xi = torch.from_numpy(np.random.default_rng(10).standard_normal(
            (2, 12, 32)).astype(np.float32)).requires_grad_()
        y = mlp(xi)
        (y.square().sum() + mlp.aux_loss).backward()
        outs.append([y.detach(), xi.grad] + [p.grad for p in mlp.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    with pytest.raises(ValueError, match="dispatch_mode"):
        moe_route(xi, mlp.gate_weight, "gshard", 4, lambda e: e,
                  dispatch_mode="int4")


# ---------------- the model -------------------------------------------------
@pytest.mark.parametrize("chunk", [0, 8], ids=["full_logits", "chunk8"])
def test_forward_with_loss_matches_jax(moe_models, chunk):
    """Loss (CE plus ``moe_aux_weight`` times the aux) and every
    parameter's gradient of ``forward_with_loss``, the chunked
    cross-entropy off and on."""
    jm, params = moe_models
    jm.cfg.loss_chunk = chunk
    tm = _port_model(params, loss_chunk=chunk)
    x, y = _batch(1)
    pv, bufs = jm.functional_state()

    def f(p):
        with no_grad():
            loss, _ = jm.functional_call(p, bufs, Tensor(jnp.asarray(x)),
                                         Tensor(jnp.asarray(y)),
                                         method="forward_with_loss")
        return loss._value

    try:
        want_loss, want_grads = jax.value_and_grad(f)(pv)
    finally:
        jm.cfg.loss_chunk = 0
    loss = tm.forward_with_loss(torch.from_numpy(x).long(),
                                torch.from_numpy(y).long())
    loss.backward()
    assert abs(float(want_loss) - loss.item()) <= TOL
    assert tm.gpt.moe_aux_loss is not None
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        assert _err(p.grad, want_grads[name]) <= TOL, name


@pytest.mark.parametrize("weight", [0.0, 0.1])
def test_aux_weight_enters_forward_with_loss_only(moe_models, weight):
    """``forward_with_loss`` is ``loss(forward())`` plus ``moe_aux_weight``
    times the blocks' summed aux loss, as the JAX package's; ``loss()``
    alone has no aux term."""
    jm, params = moe_models
    tm = _port_model(params, moe_aux_weight=weight)
    x, y = (torch.from_numpy(a).long() for a in _batch(2))
    with torch.no_grad():
        total = tm.forward_with_loss(x, y).item()
        aux = tm.gpt.moe_aux_loss.item()
        ce = tm.loss(tm(x), y).item()
    assert abs(total - (ce + weight * aux)) <= 1e-6
    assert aux > 0
    jm.cfg.moe_aux_weight = weight
    try:
        with no_grad():
            want = float(jm.forward_with_loss(
                paddle.to_tensor(x.numpy().astype(np.int32)),
                paddle.to_tensor(y.numpy().astype(np.int32)))._value)
    finally:
        jm.cfg.moe_aux_weight = 0.01
    assert abs(total - want) <= TOL


def test_moe_blocks_sit_at_every_kth_and_run_outside_recompute(monkeypatch):
    """MoE FFNs at ``i % k == k - 1``; with recompute on, only the dense
    blocks go through ``recompute``."""
    import importlib

    tm = gpt_moe_tiny(num_layers=6, moe_every_k=3, use_recompute=True,
                      device="cpu")
    assert [isinstance(b.mlp, GPTMoEMLP) for b in tm.gpt.layers] \
        == [False, False, True, False, False, True]
    gmod = importlib.import_module("paddle_tpu_torch.models.gpt")
    seen = []
    real = gmod.recompute

    def spy(block, *a, **k):
        seen.append(block)
        return real(block, *a, **k)

    monkeypatch.setattr(gmod, "recompute", spy)
    x, y = (torch.from_numpy(a).long() for a in _batch(3))
    tm.train()
    tm.forward_with_loss(x, y).backward()
    assert seen == [tm.gpt.layers[i] for i in (0, 1, 3, 4)]
    assert all(p.grad is not None for p in tm.parameters())


def test_train_step_matches_jax():
    """3 AdamW steps through ``make_sharded_train_step``, recompute on and
    the chunked loss: losses to ``TOL`` and every parameter to
    ``PARAM_TOL`` after step 3, but for the entries whose step-1 gradient
    is rounding noise (below 1e-6 of its tensor's largest, as the K third
    of each qkv bias, whose true gradient is zero): Adam divides a
    gradient by its own magnitude, so both sides step their noise by up to
    lr, in whichever direction it points, and those entries are held to
    Adam's bound, 2 * 3 * lr."""
    over = dict(use_recompute=True, loss_chunk=8)
    jm, params = _jax_model(**over)
    tm = _port_model(params, **over)
    jstep = j_make_step(jm, paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters()))
    tstep = make_sharded_train_step(tm, AdamW(
        learning_rate=LR, parameters=tm.named_parameters()), device="cpu")
    jl, tl = [], []
    for i in range(3):
        x, y = _batch(10 + i)
        jl.append(float(jstep(x, y)))
        tl.append(float(tstep(x, y)))
        if i == 0:
            g1 = {n: p.grad.abs().numpy() for n, p in tm.named_parameters()}
            noise = {n: g <= 1e-6 * g.max() for n, g in g1.items()}
    assert np.abs(np.array(jl) - np.array(tl)).max() <= TOL
    # every tensor moved, the experts and the gate included
    assert all(not np.array_equal(params[n], p.detach().numpy())
               for n, p in tm.named_parameters())
    D, H = tm.cfg.head_dim, tm.cfg.num_heads
    assert all(noise[f"gpt.layers.{i}.attn.qkv.bias"][H * D:2 * H * D].all()
               for i in range(2))
    # besides exact zeros (the position rows past S), noise is rare
    n_noise = sum(int((noise[n] & (g > 0)).sum()) for n, g in g1.items())
    assert n_noise <= 1e-3 * sum(g.size for g in g1.values()), n_noise
    for name, p in tm.named_parameters():
        diff = np.abs(np.asarray(jstep.params[name]) - p.detach().numpy())
        assert diff[noise[name]].max(initial=0) <= 2 * 3 * LR, name
        assert diff[~noise[name]].max(initial=0) <= PARAM_TOL, \
            (name, diff[~noise[name]].max())


# ---------------- serving ---------------------------------------------------
def _prompts(seed):
    """Five prompts sharing a 20-token prefix (prefix hits at page 8)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 128, 20).tolist()
    return [base + rng.integers(1, 128, n).tolist() for n in (3, 9, 14, 5, 11)]


@pytest.mark.parametrize("mode", ["generate", "paged", "prefix_cache",
                                  "speculative", "dense"])
def test_greedy_tokens_match_jax(moe_models, mode):
    """Greedy tokens of ``generate`` (3 rows) and of the ``Engine`` (5
    prompts through 2 slots, mid-run admission) in its four modes equal the
    JAX package's: every program's ``T`` sets its capacity, and every
    slot's token, live or not, competes for it, on both sides."""
    jm, params = moe_models
    tm = _port_model(params)
    tm.eval()
    prompts = _prompts(4)
    if mode == "generate":
        ids = np.asarray([p[:20] for p in prompts[:3]], np.int64)
        with no_grad():
            want = np.asarray(jm.generate(paddle.to_tensor(
                ids.astype(np.int32)), max_new_tokens=10).numpy())
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=10).numpy()
        assert np.array_equal(got, want)
        assert len(set(got[:, 20:].ravel().tolist())) > 4
        return
    opts = {"paged": {}, "prefix_cache": dict(prefix_cache=True),
            "speculative": dict(speculative=2),
            "dense": dict(kv_layout="dense")}[mode]
    cfg = dict(max_batch_size=2, max_seq_len=64, **opts)
    if mode != "dense":
        cfg["page_size"] = 8
    jeng = JEngine(jm, JEngineConfig(**cfg))
    jreqs = [jeng.add_request(p, JSamplingParams(max_new_tokens=12))
             for p in prompts]
    while jeng.has_unfinished:
        jeng.step()
    eng = Engine(tm, EngineConfig(**cfg), device="cpu")
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=12))
            for p in prompts]
    while eng.has_unfinished:
        eng.step()
    got = [r.output_ids for r in reqs]
    assert got == [r.output_ids for r in jreqs]
    assert len({t for o in got for t in o}) > 4
    if mode == "prefix_cache":
        assert sum(r.prefix_hit_blocks > 0 for r in reqs) >= 3
        assert [r.prefix_hit_blocks for r in reqs] \
            == [r.prefix_hit_blocks for r in jreqs]


# ---------------- weights and what is not ported -----------------------------
def test_from_paddle_tpu_reads_the_moe_blocks(moe_models):
    """A JAX GPT-MoE dict loads name for name in the port's order (block 1
    with the MoE set); a block mixing the dense and the MoE set raises."""
    _, params = moe_models
    sd = from_paddle_tpu(params)
    assert list(sd) == list(gpt_moe_tiny(device="cpu").state_dict())
    assert list(sd) == expected_names(2, moe_layers={1})
    assert sd["gpt.layers.1.mlp.w1"].shape == (4, 64, 256)
    mixed = dict(params)
    mixed["gpt.layers.1.mlp.fc1.weight"] = params[
        "gpt.layers.0.mlp.fc1.weight"]
    with pytest.raises(KeyError, match="unexpected"):
        from_paddle_tpu(mixed)
    half = {k: v for k, v in params.items()
            if k != "gpt.layers.1.mlp.gate_weight"}
    with pytest.raises(KeyError, match="missing"):
        from_paddle_tpu(half)


def test_unported_moe_options_raise():
    """A group of one rank routes as no group does, bit for bit, and the
    exchanges over it are the identity; the other distributed options name
    their A5 item; an activation without a port names A8."""
    from paddle_tpu_torch.distributed.collective import Group

    one = Group([0])
    layers = []
    for group in (None, one):
        torch.manual_seed(0)
        layers.append(tmoe.MoELayer(
            8, [tmoe.ExpertMLP(8, 16, device="cpu") for _ in range(4)],
            group=group, device="cpu"))
    assert layers[1].num_experts == 4 and layers[1].groups is None
    xs = torch.randn(2, 5, 8, requires_grad=True)
    outs = []
    for layer in layers:
        out = layer(xs)
        (out * torch.arange(out.numel()).view_as(out)).sum().backward()
        outs.append((out.detach(), layer.aux_loss.detach(), xs.grad.clone(),
                     {k: p.grad for k, p in layer.named_parameters()}))
        xs.grad = None
    (o0, a0, g0, p0), (o1, a1, g1, p1) = outs
    assert torch.equal(o0, o1) and torch.equal(a0, a1) and torch.equal(g0, g1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    x = torch.ones(3, 4)
    for group in (None, one):
        assert tmoe.global_scatter(x, [3], [3], group=group) is x
        assert tmoe.global_gather(x, [3], [3], group=group) is x
    # a mixed dense/MoE stack does not pipeline (the JAX package's
    # message); every block MoE does
    with pytest.raises(NotImplementedError, match="homogeneous stack"):
        gpt_moe_tiny(device="cpu").pipeline_spec()
    spec = gpt_moe_tiny(device="cpu", moe_every_k=1).pipeline_spec()
    assert (spec.block_prefix, spec.n_blocks, spec.aux_weight) == (
        "gpt.layers", 2, 0.01) and spec.block_with_aux is not None
    for over in (dict(sequence_parallel=True),
                 dict(context_parallel="ulysses")):
        with pytest.raises(NotImplementedError, match="A5.7"):
            GPTConfig(**_moe_cfg(**over))
    with pytest.raises(NotImplementedError, match="A8"):
        tmoe.ExpertMLP(8, 8, "gelu_new")
    with pytest.raises(ValueError, match="top_k"):
        tmoe.MoELayer(8, [tmoe.ExpertMLP(8, 8)], top_k=3)
    assert tmoe.GShardGate(8, 4).top_k == 2
    assert tmoe.SwitchGate(8, 4).top_k == 1
