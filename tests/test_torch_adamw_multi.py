"""The grouped AdamW update (``kernels.fused_adamw_multi`` under
``Optimizer.apply_gradients``) on the CPU: bitwise the per-tensor path it
replaced, within rounding of the JAX package's ``AdamW``, and the kernel
table's chunks, which must cover every element of every tensor once."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build, fused_optim
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW

LR, WD = 1e-3, 0.01
#: the JAX comparison's rate, bench.py's (and ``test_torch_training``'s
#: ``adamw_master_bf16``): a bf16 moment that rounds the other way on one
#: side moves that step's update by up to 2^-8 of it, ~4e-6 at lr 1e-3,
#: past the fp32 tolerance; ~4e-7 at 1e-4
JAX_LR = 1e-4
#: the one parameter left without a gradient, and the one kept in fp16
#: (no kernel takes an fp16 gradient: it goes through ``_adam``)
NO_GRAD = "gpt.layers.1.ln2.bias"
FP16 = "gpt.final_ln.weight"


def _ratio(name):
    return 0.5 if ".attn." in name else 1.0


def _decays(name):
    return not (name.endswith(".bias") or "ln" in name)


def _optimizer(params, lr=LR):
    return AdamW(learning_rate=lr, parameters=params, weight_decay=WD,
                 multi_precision=True, moment_dtype="bfloat16",
                 lr_ratio=_ratio, apply_decay_param_fun=_decays)


def _tiny_params():
    """The tiny GPT's parameters in bf16 (FP16 in fp16) and 3 steps of
    gradients in their dtypes, NO_GRAD's None; numpy from a seed."""
    rng = np.random.default_rng(16)
    model = GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    dts = {n: torch.float16 if n == FP16 else torch.bfloat16 for n in shapes}
    params = {n: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
              .to(dts[n]) for n, sh in shapes.items()}
    grads = [{n: None if n == NO_GRAD else torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32)).to(dts[n])
        for n, sh in shapes.items()} for _ in range(3)]
    return params, grads


def _per_tensor_step(opt, named):
    """``apply_gradients`` as it ran before the grouped launch: each tensor
    the kernel takes through ``fused_adamw_update`` on its own, the others
    through ``_adam``, then a ``copy_`` of each master."""
    opt.init_state(named)
    for name, p in named.items():
        if p.grad is None:
            continue
        s = opt.state[name]
        value = s.get("master_weight", p)
        if (value.dtype, p.grad.dtype, s["moment1"].dtype) in \
                fused_optim.COMBOS:
            b1p, b2p = opt._next_pows(s)
            K.fused_adamw_update(value, p.grad, s["moment1"], s["moment2"],
                                 lr=LR * _ratio(name), beta1=0.9,
                                 beta2=0.999, eps=1e-8,
                                 weight_decay=WD if _decays(name) else 0.0,
                                 beta1_pow=b1p, beta2_pow=b2p)
        else:
            opt._update(value, p.grad.to(value.dtype), s, LR, name)
        if value is not p:
            p.copy_(value)


def test_grouped_apply_gradients_is_the_per_tensor_path():
    """3 grouped steps over the tiny GPT's parameters (bf16 with fp32
    masters, bf16 moments, an ``lr_ratio``, an ``apply_decay_param_fun``,
    one parameter without a gradient, one fp16 parameter) against the same
    steps tensor by tensor: parameters, moments, masters, bf16 copies and
    step powers bitwise; the fp16 parameter's master copied by ``copy_``
    (counted), every other parameter written by the kernel's plain
    version."""
    params, grads = _tiny_params()
    runs = {}
    for grouped in (True, False):
        named = {n: p.clone() for n, p in params.items()}
        opt = _optimizer(named)
        for gs in grads:
            for n, p in named.items():
                p.grad = gs[n]
            if grouped:
                opt.step()
            else:
                _per_tensor_step(opt, named)
        runs[grouped] = (named, opt)
    (named, opt), (ref, ref_opt) = runs[True], runs[False]
    assert opt.master_copies == 3  # FP16's, once a step
    for n, p in named.items():
        assert p.dtype == params[n].dtype and torch.equal(p, ref[n]), n
        s, r = opt.state[n], ref_opt.state[n]
        assert set(s) == set(r) == {"moment1", "moment2", "beta1_pow",
                                    "beta2_pow", "master_weight"}
        for k in s:
            if torch.is_tensor(s[k]):
                assert s[k].dtype == r[k].dtype and torch.equal(s[k], r[k])
            else:
                assert type(s[k]) is np.float32 and s[k] == r[k], (n, k)
    assert opt.state[NO_GRAD]["beta1_pow"] == np.float32(1)
    assert torch.equal(named[NO_GRAD], params[NO_GRAD])
    assert opt.state[FP16]["beta2_pow"] == np.float32(
        np.float32(np.float32(0.999) * np.float32(0.999)) * np.float32(0.999))


def _tol(dtype, want):
    """``test_adamw_ref_matches_pallas``'s: 2e-6 for fp32 (a few ulps of
    |p| < 8); one rounding step of the largest value in bf16 and fp16 (8
    and 11 significant bits)."""
    if dtype == torch.float32:
        return 2e-6
    top = float(np.abs(want).max())
    bits = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    return 2.0 ** (np.floor(np.log2(top)) + 1 - bits) if top else 0.0


def test_grouped_steps_match_the_jax_adamw():
    """The same 3 steps through the JAX package's pure ``apply_gradients``
    (its ``lr_ratio`` is stored, not applied, so each parameter's rate is
    passed as its ``lr``), with ``test_adamw_ref_matches_pallas``'s
    tolerances (``_tol``): fp32 masters to 2e-6, bf16 parameters and
    moments, and the fp16 parameter, to one rounding step of their largest
    value. The JAX side rounds 1 - b2 and 1 - lr*wd in double, the kernel
    in fp32, so a bf16 moment may round the other way at a boundary."""
    params, grads = _tiny_params()
    named = {n: p.clone() for n, p in params.items()}
    opt = _optimizer(named, JAX_LR)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
    jp = {n: jnp.asarray(p.float().numpy()).astype(jdt[p.dtype])
          for n, p in params.items()}
    jopt = paddle.optimizer.AdamW(
        learning_rate=JAX_LR, weight_decay=WD, multi_precision=True,
        moment_dtype="bfloat16", apply_decay_param_fun=_decays)
    js = jopt.init_state_pytree(jp)
    for gs in grads:
        for n, p in named.items():
            p.grad = gs[n]
        opt.step()
        # one call per rate: the JAX optimizer takes one lr a call
        for ratio in {_ratio(n) for n in gs}:
            names = [n for n, g in gs.items()
                     if g is not None and _ratio(n) == ratio]
            new, st = jopt.apply_gradients(
                {n: jp[n] for n in names},
                {n: jnp.asarray(gs[n].float().numpy()).astype(
                    jdt[gs[n].dtype]) for n in names},
                {n: js[n] for n in names}, lr=JAX_LR * ratio)
            jp.update(new)
            js.update(st)
    for n, p in named.items():
        pairs = [(jp[n], p)] + [(js[n][k], opt.state[n][k]) for k in
                                ("moment1", "moment2", "master_weight")]
        for want, got in pairs:
            want = np.asarray(want.astype(jnp.float32))
            err = float(np.abs(want - got.float().numpy()).max())
            assert err <= _tol(got.dtype, want), (n, got.dtype, err)
        assert float(js[n]["beta1_pow"]) == float(opt.state[n]["beta1_pow"])


@pytest.mark.parametrize("n", [0, 1, 33, 65536 + 17])
def test_table_chunks_cover_every_element_once(n):
    """The kernel's table over tensors of ``n`` elements beside an
    unaligned dim-0 slice view and a tensor past one chunk: each entry's
    chunks (``table``'s ``chunk0``, read as the kernel reads it) cover its
    elements ``[0, n)`` once, in order, each at most ``CHUNK`` long; the
    records hold each tensor's pointers, its bf16 copy's or 0, and its
    constants."""
    leaf = torch.zeros(3, 5)
    view = leaf[1:2]  # 20 bytes into the leaf's storage
    sizes = [n, 7, n, 2 * fused_optim.CHUNK + 1]
    tensors = [torch.zeros(s) for s in sizes]
    tensors[1] = view.reshape(-1)
    entries = [(t, t.clone(), t.clone(), t.clone(),
                t.to(torch.bfloat16) if i % 2 else None)
               for i, t in enumerate(tensors)]
    hp = fused_optim._hyper([1e-3] * 4, 0.9, 0.999, 1e-8, [0.01, 0, 0.01, 0],
                            [0.9] * 4, [0.999] * 4)
    tab, chunk0 = fused_optim.table(entries, hp)
    assert tab.dtype.itemsize == 64 and chunk0.dtype == np.int32
    assert tab["p"][1] == view.data_ptr() and view.data_ptr() % 16
    assert list(tab["low"] == 0) == [True, False, True, False]
    assert list(tab["n"]) == [t.numel() for t in tensors]
    assert np.array_equal(tab["decay"], hp["decay"])
    seen = [np.zeros(t.numel(), np.int64) for t in tensors]
    for e, t in enumerate(tensors):
        for c in range(chunk0[e], chunk0[e + 1]):
            lo = (c - chunk0[e]) * fused_optim.CHUNK
            hi = min(lo + fused_optim.CHUNK, t.numel())
            assert 0 <= lo < hi
            seen[e][lo:hi] += 1
    assert chunk0[0] == 0 and all(np.all(s == 1) for s in seen)
    assert chunk0[-1] == sum(-(-s // fused_optim.CHUNK) for s in
                             [t.numel() for t in tensors])


def test_table_layout_matches_the_kernel_source():
    """``CHUNK``, ``MAX_ENTRIES`` and ``_ENTRY`` as ``csrc/fused_adamw.cu``
    defines them: its NT x VEC x UNROLL, its MAX_ENTRIES and its 64-byte
    ``Entry`` (five pointers, n, four floats, in that order)."""
    src = (_build.CSRC / "fused_adamw.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert fused_optim.CHUNK == const["NT"] * const["VEC"] * const["UNROLL"]
    assert fused_optim.MAX_ENTRIES == const["MAX_ENTRIES"]
    fields = re.search(r"struct Entry \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", fields) == ["p", "g", "m", "v", "low"]
    assert list(fused_optim._ENTRY.names) == [
        "p", "g", "m", "v", "low", "n", "lr", "decay", "omb1p", "omb2p"]
    assert "float lr, decay, omb1p, omb2p;" in fields


def test_multi_wrapper_on_cpu_tensors():
    """On CPU tensors ``fused_adamw_multi`` runs ``adamw_ref`` tensor by
    tensor with each tensor's constants (a float for all, or a list), writes
    each bf16 copy from the new fp32 value, and counts no launch; it refuses
    lists of other lengths, a copy beside a bf16 param and a device no
    kernel runs on."""
    rng = np.random.default_rng(3)
    shapes = [(33,), (4, 5), (0,)]
    dts = [(torch.float32,) * 3, (torch.float32, torch.bfloat16,
                                  torch.bfloat16), (torch.bfloat16,) * 3]
    cols = [[torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             .to(d) for d in (pd, gd, md, md)]
            for sh, (pd, gd, md) in zip(shapes, dts)]
    ps, gs = [c[0] for c in cols], [c[1] for c in cols]
    ms, vs = [0.1 * c[2] for c in cols], [0.1 * c[3].abs() for c in cols]
    lows = [None, ps[1].to(torch.bfloat16), None]
    hp = dict(lr=[1e-3, 2e-3, 3e-3], weight_decay=0.01,
              beta1_pow=[0.9, 0.81, 0.729], beta2_pow=0.999)
    want = [K.adamw_ref(p, g, m, v, lr=hp["lr"][i], beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decay=0.01,
                        beta1_pow=hp["beta1_pow"][i], beta2_pow=0.999)
            for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs))]
    K.reset_launch_counts()
    K.fused_adamw_multi(ps, gs, ms, vs, beta1=0.9, beta2=0.999, eps=1e-8,
                        low=lows, **hp)
    assert K.launch_counts()["fused_adamw_multi"] == 0
    for got, w in zip(zip(ps, ms, vs), want):
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, w))
    assert torch.equal(lows[1], want[1][0].to(torch.bfloat16))
    with pytest.raises(ValueError, match="as long"):
        K.fused_adamw_multi(ps, gs[:2], ms, vs, lr=1e-3, beta1=0.9,
                            beta2=0.999, eps=1e-8, weight_decay=0.0,
                            beta1_pow=0.9, beta2_pow=0.999)
    with pytest.raises(ValueError, match="bf16 copy"):
        K.fused_adamw_multi(ps[2:], gs[2:], ms[2:], vs[2:], lr=1e-3,
                            beta1=0.9, beta2=0.999, eps=1e-8,
                            weight_decay=0.0, beta1_pow=0.9, beta2_pow=0.999,
                            low=[torch.zeros(0, dtype=torch.bfloat16)])
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_adamw_multi([meta], [meta], [meta], [meta], lr=1e-3,
                            beta1=0.9, beta2=0.999, eps=1e-8,
                            weight_decay=0.0, beta1_pow=0.9, beta2_pow=0.999)
