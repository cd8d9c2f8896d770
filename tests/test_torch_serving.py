"""The port's serving slice against the JAX package's, on the CPU.

Same weights on both sides: a ``gpt_tiny(num_kv_heads=2)`` JAX model with
random numpy weights, converted by ``paddle_tpu_torch.weights`` into the
port's ``GPTForCausalLM``. The JAX engine runs the paged layout with the
Pallas paged-decode kernel in interpret mode; the port's engine runs on the
CPU, where every kernel wrapper takes its plain version. Everything is
fp32, where the two attention numerics (natural-exp ``_sdpa_ref`` in JAX on
the CPU, exp2 flash in the port) agree to ~1e-6.
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
from paddle_tpu_torch.serving import (Engine, EngineConfig, PageAllocator,
                                      SamplingParams)
from paddle_tpu_torch.serving import kv_cache as tkvc
from paddle_tpu_torch.serving import sampling as tsampling
from paddle_tpu_torch.weights import from_paddle_tpu

# fp32 logits of magnitude ~10 through two blocks: summation order only
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, numpy params): random weights wide enough
    (std 0.2) that greedy decoding does not collapse onto one token."""
    paddle.seed(0)
    jm = gpt_tiny(dropout=0.0, num_kv_heads=2)
    jm.eval()
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
                                     "dropout": 0.0}), device="cpu")
    got = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    tm.load_state_dict(from_paddle_tpu(got))
    tm.eval()
    return jm, tm, params


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, n).tolist() for n in lengths]


@pytest.mark.parametrize("page_size,max_seq_len,max_new", [
    (16, 64, 6),    # pages larger than the 8-token bucket: partial writes
    (4, 32, 40),    # multi-page prefill, decode page growth, cache_full
])
def test_greedy_tokens_match_jax_engine(models, page_size, max_seq_len,
                                        max_new):
    """5 prompts of different lengths through 2 slots (mid-run admission):
    token-identical greedy output and finish reasons."""
    jm, tm, _ = models
    prompts = _prompts(1, (3, 9, 20, 5, 14))
    want = JEngine(jm, JEngineConfig(
        max_batch_size=2, max_seq_len=max_seq_len, page_size=page_size,
        paged_attention_impl="interpret")).generate(
        prompts, JSamplingParams(max_new_tokens=max_new))
    eng = Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=max_seq_len,
                                  page_size=page_size), device="cpu")
    got = eng.generate(prompts, SamplingParams(max_new_tokens=max_new))
    assert got == want
    assert len({t for o in got for t in o}) > 4  # not one repeated token
    # every page went back to the pool
    assert eng.page_alloc.num_free == eng.page_alloc.num_allocatable
    assert eng.cache.free_slots == 2


def test_prefill_and_decode_logits_match(models):
    """Prefill's last-token logits and K/V, then one paged decode step from
    identical pools: logits and the written pools agree within fp32
    tolerance."""
    jm, tm, _ = models
    ids = np.zeros((1, 16), np.int64)
    n = 11
    ids[0, :n] = _prompts(2, (n,))[0]
    with no_grad():
        jl, jkvs = jm.prefill_with_cache(
            paddle.to_tensor(ids.astype(np.int32)),
            lengths=paddle.to_tensor(np.array([n], np.int32)))
    with torch.no_grad():
        tl, tkvs = tm.prefill_with_cache(torch.from_numpy(ids),
                                         lengths=torch.tensor([n]))
    assert np.abs(np.asarray(jl.numpy()) - tl.numpy()).max() <= LOGIT_TOL
    for (jk, jv), (tk, tv) in zip(jkvs, tkvs):
        assert np.abs(np.asarray(jk.numpy()) - tk.numpy()).max() <= 1e-5
        assert np.abs(np.asarray(jv.numpy()) - tv.numpy()).max() <= 1e-5

    # pools holding the prompt's K/V at a 2-slot table (slot 1 empty)
    L, Hkv, D, ps, nb = 2, 2, 16, 4, 16
    cache = tkvc.PagedKVCache(L, 2, Hkv, nb * ps, D, page_size=ps,
                              device="cpu")
    cache.assign_pages(0, [3, 1, 4, 2])
    cache.write_prefill(tkvs, cache.page_table[0], 16)
    kp, vp = cache.k.numpy().copy(), cache.v.numpy().copy()
    table = cache.page_table.copy()
    tokens = np.array([7, 0], np.int32)
    pos = np.array([n, 0], np.int32)
    with jkvc.use_paged_attention_impl("interpret"), no_grad():
        jl, jnew = jm.decode_step(
            paddle.to_tensor(tokens),
            [(paddle.to_tensor(kp[l]), paddle.to_tensor(vp[l]),
              paddle.to_tensor(table)) for l in range(L)],
            paddle.to_tensor(pos))
    with torch.no_grad():
        tl, _ = tm.decode_step(torch.from_numpy(tokens).long(),
                               cache.layer_caches(), torch.from_numpy(pos))
    assert np.abs(np.asarray(jl.numpy()) - tl.numpy()).max() <= LOGIT_TOL
    for l, (jk, jv) in enumerate(jnew):  # in-place writes == JAX's new pools
        assert np.abs(np.asarray(jk.numpy()) - cache.k[l].numpy()).max() \
            <= 1e-5
        assert np.abs(np.asarray(jv.numpy()) - cache.v[l].numpy()).max() \
            <= 1e-5


def test_paged_write_matches_jax_incl_trash_routing():
    """In-place ``paged_write_kv`` equals the JAX functional one: ragged
    positions, a sentinel row (trash page), and a second token past the
    table's capacity (also trash)."""
    rng = np.random.default_rng(4)
    P, Hkv, ps, D, nb = 7, 2, 4, 8, 3
    pool = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    new = rng.standard_normal((3, Hkv, 2, D)).astype(np.float32)
    table = np.array([[2, 5, 1], [3, -1, -1], [-1, -1, -1]], np.int32)
    pos = np.array([nb * ps - 1, 2, 0], np.int32)
    want = jkvc.paged_write_kv(jnp.asarray(pool), jnp.asarray(new),
                               jnp.asarray(table), jnp.asarray(pos))
    got = torch.from_numpy(pool.copy())
    out = tkvc.paged_write_kv(got, torch.from_numpy(new),
                              torch.from_numpy(table), torch.from_numpy(pos))
    assert out is got  # written in place
    # rows 0 and 1 own distinct live pages; the trash page 0 takes the
    # colliding writes (row 0's overflow, row 2's empty slot), whose order
    # is unspecified on both sides
    assert np.array_equal(np.asarray(want)[1:], got.numpy()[1:])


def test_full_forward_logits_match(models):
    """The training-shaped forward (causal flash attention with GQA, no
    cache) against the JAX model's."""
    jm, tm, _ = models
    ids = np.asarray(_prompts(3, (24, 24)), np.int64)
    with no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 24, 128)
    assert np.abs(want - got).max() <= LOGIT_TOL


def test_page_allocator_invariants():
    a = PageAllocator(6)
    assert a.num_allocatable == 5
    seen = []
    while (got := a.alloc(1)) is not None:
        seen += got
    assert sorted(seen) == [1, 2, 3, 4, 5]  # trash page 0 never handed out
    a.free(seen[:3], owner="r0")
    assert a.alloc(4) is None and a.num_free == 3  # all or nothing
    with pytest.raises(ValueError, match="not allocated"):
        a.free(seen[:1])                           # double-free
    with pytest.raises(ValueError, match="not allocated"):
        a.free([0])                                # the trash page
    a.retain(seen[3:4], owner="r1")
    assert a.is_shared(seen[3])
    a.free(seen[3:4])
    assert a.refcount(seen[3]) == 1                # last reference keeps it
    with pytest.raises(ValueError):
        PageAllocator(1)


@pytest.mark.parametrize("kw", [dict(kv_layout="dense",
                                     request_trace_dir="traces"),
                                dict(request_trace_dir="traces"),
                                dict(slo=object()),
                                dict(kv_layout="dense", slo=object()),
                                dict(trace_sample_every=4)])
def test_unported_engine_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**kw)


def test_engine_config_has_the_reference_fields_in_order():
    """A positional construction written for the JAX package's
    ``EngineConfig`` lands every value in its field; the reference's TPU
    tiers of ``paged_attention_impl`` raise, naming the port's routes."""
    args = (2, 64, (16, 64), "float32", None, 1, None, "dense", 8, None,
            None, False, None)
    got, want = EngineConfig(*args), JEngineConfig(*args)
    for f in ("max_batch_size", "max_seq_len", "prefill_buckets",
              "cache_dtype", "trace_sample_every", "slo", "kv_layout",
              "page_size", "kv_pages", "paged_attention_impl",
              "prefix_cache", "speculative"):
        assert getattr(got, f) == getattr(want, f), f
    for impl in ("oracle", "interpret", "pallas"):
        with pytest.raises(ValueError, match="vector"):
            EngineConfig(paged_attention_impl=impl)


def test_engine_config_page_size_and_buckets():
    cfg = EngineConfig(max_seq_len=48)
    assert cfg.page_size == 16 and cfg.prefill_buckets == (8, 16, 32, 48)
    assert EngineConfig(max_seq_len=40).page_size == 8


def test_weight_converter_checks_names_and_keeps_dtype(models):
    _, _, params = models
    sd = from_paddle_tpu(params)
    assert list(sd) == list(GPTForCausalLM(
        GPTConfig(**{**GPT_TINY, "num_kv_heads": 2}), device="cpu")
        .state_dict())
    assert all(t.dtype == torch.float32 for t in sd.values())
    missing = dict(params)
    del missing["gpt.layers.0.attn.qkv.bias"]
    with pytest.raises(KeyError, match="missing"):
        from_paddle_tpu(missing)
    with pytest.raises(KeyError, match="unexpected"):
        from_paddle_tpu({**params, "gpt.layers.1.mlp.gate_weight": params[
            "gpt.final_ln.bias"]})
    import ml_dtypes

    bf = {k: v.astype(ml_dtypes.bfloat16) for k, v in params.items()}
    sd = from_paddle_tpu(bf)
    assert sd["gpt.final_ln.weight"].dtype == torch.bfloat16
    assert torch.equal(sd["gpt.final_ln.weight"].float(), torch.from_numpy(
        bf["gpt.final_ln.weight"].astype(np.float32)))


def test_sampling_greedy_ties_and_seeded_draws():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 0.0, 2.0]])
    assert tsampling.sample_static(logits, None, do_sample=False,
                                   temperature=1.0, top_k=0).tolist() == [1, 0]
    temps = torch.tensor([1.0, 0.5])
    top_ks = torch.tensor([0, 2])
    greedy = torch.tensor([True, False])
    draws = [tsampling.sample_batched(
        logits, torch.Generator().manual_seed(7), temps, top_ks,
        greedy).tolist() for _ in range(2)]
    assert draws[0] == draws[1]          # the generator alone decides
    assert draws[0][0] == 1              # greedy row: first maximum
    assert draws[0][1] in (0, 1, 3)      # top-2 of row 1: ties keep all 2s
