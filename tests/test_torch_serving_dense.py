"""The port's dense KV layout, ``GPTForCausalLM.generate`` and the dense
``Engine`` against the JAX package's, on the CPU.

Same weights on both sides: a ``gpt_tiny`` JAX model (GQA 4/2, and MHA
for the decode-step case) with random numpy weights (std 0.2, so greedy
decoding does not collapse onto one token), converted by
``paddle_tpu_torch.weights`` into the port's ``GPTForCausalLM``.
Everything is fp32; the port runs on the CPU, where each program runs
eagerly and every kernel wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (Engine, EngineConfig, KVCache,
                                      SamplingParams, write_kv)
from paddle_tpu_torch.weights import from_paddle_tpu

# fp32 logits of magnitude ~10 through two blocks: summation order only
LOGIT_TOL = 1e-4


def _models(num_kv_heads, seed):
    """(JAX model, port model) on the same random numpy weights."""
    paddle.seed(0)
    jm = gpt_tiny(dropout=0.0, num_kv_heads=num_kv_heads)
    jm.eval()
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
    tm = GPTForCausalLM(GPTConfig(**{**GPT_TINY, "num_kv_heads": num_kv_heads,
                                     "dropout": 0.0}), device="cpu")
    tm.load_state_dict(from_paddle_tpu(params))
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models(2, 0)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, n).tolist() for n in lengths]


@pytest.mark.parametrize("positions", [3, 13, [5, 0, 15]],
                         ids=["scalar", "scalar-clamped", "per-row"])
def test_write_kv_matches_jax_bitwise(positions):
    """A contiguous write at a scalar position (past the end, the JAX
    start clamp) and a per-row one-token scatter, in place."""
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((3, 2, 16, 8)).astype(np.float32)
    T = 1 if isinstance(positions, list) else 4
    new = rng.standard_normal((3, 2, T, 8)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    want = np.asarray(jkvc.write_kv(jnp.asarray(cache), jnp.asarray(new),
                                    jnp.asarray(pos)))
    for p in ((positions, torch.from_numpy(pos))
              if not isinstance(positions, list) else
              (torch.from_numpy(pos),)):
        got = torch.from_numpy(cache.copy())
        assert write_kv(got, torch.from_numpy(new), p) is got
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_decode_step_over_dense_caches_matches_jax(models, num_kv_heads):
    """Prefill two ragged prompts into dense caches, then one decode step
    at per-row positions: logits and the written caches agree."""
    jm, tm = models if num_kv_heads == 2 else _models(num_kv_heads, 5)
    L, B, S_max = 2, 2, 24
    cache = KVCache(L, B, num_kv_heads, S_max, 16, device="cpu")
    lens = [7, 12]
    for b, prompt in enumerate(_prompts(2, lens)):
        ids = torch.zeros((1, 16), dtype=torch.long)
        ids[0, :lens[b]] = torch.tensor(prompt)
        with torch.no_grad():
            _, kvs = tm.prefill_with_cache(ids, lengths=torch.tensor([lens[b]]))
        cache.write_prefill(kvs, torch.tensor([b]), 16)
    kc, vc = cache.k.numpy().copy(), cache.v.numpy().copy()
    tokens = np.array([9, 31], np.int32)
    pos = np.array(lens, np.int32)
    with no_grad():
        jl, jnew = jm.decode_step(
            paddle.to_tensor(tokens),
            [(paddle.to_tensor(kc[l]), paddle.to_tensor(vc[l]))
             for l in range(L)], paddle.to_tensor(pos))
    with torch.no_grad():
        tl, tnew = tm.decode_step(torch.from_numpy(tokens).long(),
                                  cache.layer_caches(), torch.from_numpy(pos))
    assert np.abs(np.asarray(jl.numpy()) - tl.numpy()).max() <= LOGIT_TOL
    for l, ((jk, jv), (tk, tv)) in enumerate(zip(jnew, tnew)):
        assert tk.data_ptr() == cache.k[l].data_ptr()  # written in place
        assert np.abs(np.asarray(jk.numpy()) - tk.numpy()).max() <= 1e-5
        assert np.abs(np.asarray(jv.numpy()) - tv.numpy()).max() <= 1e-5


@pytest.mark.parametrize("case", ["no-eos", "eos-fill", "eos-stop",
                                  "zero-new"])
def test_generate_greedy_matches_jax(models, case):
    """Greedy ``generate``: the same ids as the JAX package's, shape
    included: without eos; with row 0's third token as eos (row 0 filled
    with it after); with a one-row batch's fourth token as eos (early
    stop); and ``max_new_tokens=0``."""
    jm, tm = models
    ids = np.asarray(_prompts(3, (9, 9, 9)), np.int64)
    if case == "eos-stop":
        ids = ids[:1]
    max_new = 0 if case == "zero-new" else 10

    def run(eos):
        with no_grad():
            j = np.asarray(jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                                       max_new_tokens=max_new,
                                       eos_token_id=eos).numpy())
        t = tm.generate(torch.from_numpy(ids), max_new_tokens=max_new,
                        eos_token_id=eos)
        return j, t.numpy()

    want, got = run(None)
    eos = None
    if case == "eos-fill":
        eos = int(want[0, 9 + 2])
    elif case == "eos-stop":
        eos = int(want[0, 9 + 3])
    if eos is not None:
        want, got = run(eos)
    assert got.dtype == np.int64 and got.shape == want.shape
    assert np.array_equal(got, want)
    if case == "eos-fill":
        assert (got[0, 9 + 2:] == eos).all()
    if case == "eos-stop":
        assert got.shape == (1, 9 + 4)
    if case == "no-eos":
        assert len(set(got[:, 9:].ravel().tolist())) > 4


def test_dense_engine_matches_jax_dense_engine(models):
    """5 prompts through 2 dense slots (mid-run admission, a ``cache_full``
    finish): token-identical greedy output and finish reasons, the port's
    dense engine equal to its paged one, every slot free after."""
    jm, tm = models
    prompts = _prompts(4, (3, 9, 20, 5, 14))
    sp = dict(max_new_tokens=20)
    jeng = JEngine(jm, JEngineConfig(max_batch_size=2, max_seq_len=32,
                                     kv_layout="dense"))
    jreqs = [jeng.add_request(p, JSamplingParams(**sp)) for p in prompts]
    while jeng.has_unfinished:
        jeng.step()
    eng = Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=32,
                                  kv_layout="dense"), device="cpu")
    assert isinstance(eng.cache, KVCache) and eng.page_alloc is None
    reqs = [eng.add_request(p, SamplingParams(**sp)) for p in prompts]
    while eng.has_unfinished:
        eng.step()
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    assert [r.finish_reason for r in reqs] \
        == [r.finish_reason for r in jreqs]
    assert "cache_full" in [r.finish_reason for r in reqs]
    assert eng.cache.free_slots == 2
    assert sorted(eng.steps) == ["decode", "prefill:16", "prefill:32",
                                 "prefill:8"]
    paged = Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=32),
                   device="cpu").generate(prompts, SamplingParams(**sp))
    assert paged == [r.output_ids for r in reqs]


def test_dense_layout_refuses_what_it_cannot_do(models):
    _, tm = models
    for kw in (dict(prefix_cache=True), dict(speculative=2)):
        with pytest.raises(ValueError, match="kv_layout='paged'"):
            EngineConfig(kv_layout="dense", **kw)
    with pytest.raises(ValueError, match="kv_layout"):
        EngineConfig(kv_layout="ragged")
    eng = Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=32,
                                  kv_layout="dense"), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        eng.step_program("extend:8")
    with pytest.raises(ValueError, match="prefill:T"):
        eng.step_program("prefill:12")  # not a bucket
    with pytest.raises(NotImplementedError, match="paged KV layout"):
        tm.extend_step(torch.ones((2, 3), dtype=torch.long),
                       eng.cache.layer_caches(), torch.tensor([4, 4]))


def test_sampled_generate_repeats_under_the_same_seed(models):
    """A sampled ``generate`` draws from its generator only: the same seed
    gives the same ids, and the generator advances by the draws."""
    _, tm = models
    ids = torch.from_numpy(np.asarray(_prompts(5, (6, 6)), np.int64))
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5, top_k=20)
    runs = [tm.generate(ids, generator=torch.Generator().manual_seed(7),
                        **kw) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    g = torch.Generator().manual_seed(7)
    first, second = (tm.generate(ids, generator=g, **kw) for _ in range(2))
    assert torch.equal(first, runs[0]) and not torch.equal(first, second)
