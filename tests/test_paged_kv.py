"""Paged KV-cache: equivalence with the dense cache + allocator behavior."""
import numpy as np
import pytest

from gemma_tpu.gguf import GGMLType, GGUFReader
from gemma_tpu.models import load_params
from gemma_tpu.runtime import Engine, EngineConfig
from gemma_tpu.runtime.paged_kv import PageAllocator
from gemma_tpu.runtime.scheduler import Request, Scheduler
from gemma_tpu.testing import TINY_CONFIG, make_gguf


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("p") / "m.gguf"
    make_gguf(path, TINY_CONFIG, weight_type=GGMLType.F32, seed=3)
    return load_params(GGUFReader(path), mode="dequant")


def test_allocator():
    a = PageAllocator(8)
    assert a.free_pages == 7  # page 0 reserved as trash
    p = a.allocate(3)
    assert len(p) == 3 and 0 not in p
    assert a.allocate(5) is None  # only 4 left
    a.release(p)
    assert a.free_pages == 7


def test_paged_scheduler_matches_dense(model):
    cfg, params = model
    dense_eng = Engine(cfg, params, EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False))
    paged_eng = Engine(
        cfg, params,
        EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False,
                     paged=True, page_size=16, n_pages=12),
    )
    prompts = {"a": [1, 7, 300], "b": [1, 44, 260, 9, 77], "c": [1, 5, 311, 42]}

    def run(eng):
        s = Scheduler(eng)
        for rid, p in prompts.items():
            s.submit(Request(rid, p, max_new_tokens=6))
        s.run()
        return {r.id: r.tokens for r in s.finished}

    assert run(paged_eng) == run(dense_eng)


def test_paged_pool_exhaustion_queues(model):
    cfg, params = model
    # tiny pool: only enough pages for one request at a time
    eng = Engine(
        cfg, params,
        EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False,
                     paged=True, page_size=16, n_pages=3),  # 2 usable pages
    )
    s = Scheduler(eng)
    s.submit(Request("a", [1, 7, 300], max_new_tokens=4))
    s.submit(Request("b", [1, 44, 260], max_new_tokens=4))
    s.run()
    assert len(s.finished) == 2  # both eventually served (serially)
    dense = Engine(cfg, params, EngineConfig(max_seq_len=64, donate_cache=False))
    for r in s.finished:
        want = dense.generate([{"a": [1, 7, 300], "b": [1, 44, 260]}[r.id]], 4)[0]
        assert r.tokens == want, r.id


def test_paged_slot_reuse_no_corruption(model):
    """A finished slot's stale decodes must not corrupt a new request's pages."""
    cfg, params = model
    eng = Engine(
        cfg, params,
        EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False,
                     paged=True, page_size=16, n_pages=10),
    )
    s = Scheduler(eng)
    s.submit(Request("short", [1, 33], max_new_tokens=2))
    s.submit(Request("long", [1, 44, 260, 9, 77], max_new_tokens=10))
    s.run()
    # admit a new request that will re-use the freed pages while 'long'... done
    s.submit(Request("next", [1, 5, 311, 42], max_new_tokens=6))
    s.run()
    dense = Engine(cfg, params, EngineConfig(max_seq_len=64, donate_cache=False))
    by_id = {r.id: r.tokens for r in s.finished}
    assert by_id["next"] == dense.generate([[1, 5, 311, 42]], 6)[0]
    assert by_id["long"] == dense.generate([[1, 44, 260, 9, 77]], 10)[0]


def test_direct_paged_generate_matches_dense(model):
    """Engine.generate on a paged engine WITHOUT a scheduler: new_cache must
    hand out a real per-slot page layout. Regression: a fresh all-zeros page
    table routed every prefill/decode write to the trash page, silently
    producing attention over garbage."""
    cfg, params = model
    dense = Engine(cfg, params, EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False))
    paged = Engine(
        cfg, params,
        EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False,
                     paged=True, page_size=16),
    )
    prompts = [[1, 7, 300], [1, 44, 260, 9, 77]]
    assert paged.generate(prompts, 8) == dense.generate(prompts, 8)
    # fused path too (covers the unrolled block program over paged writes)
    np.testing.assert_array_equal(
        paged.generate_fused(prompts, 8), dense.generate_fused(prompts, 8)
    )


def test_identity_layout_rejects_small_pool(model):
    cfg, params = model
    eng = Engine(
        cfg, params,
        EngineConfig(max_seq_len=64, max_batch=2, donate_cache=False,
                     paged=True, page_size=16, n_pages=6),
    )
    with pytest.raises(ValueError, match="identity_layout"):
        eng.new_cache(2)
    # trash layout (scheduler mode) is fine with any pool size
    eng.new_cache(2, identity_pages=False)


def test_paged_int8_kv(model):
    cfg, params = model
    eng = Engine(
        cfg, params,
        EngineConfig(max_seq_len=64, max_batch=1, donate_cache=False,
                     paged=True, page_size=16, n_pages=8, kv_quantized=True),
    )
    s = Scheduler(eng)
    s.submit(Request("a", [1, 7, 300, 42], max_new_tokens=4))
    s.run()
    toks = s.finished[0].tokens
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)
    # int8 KV should usually match the float argmax on a tiny model
    dense = Engine(cfg, params, EngineConfig(max_seq_len=64, donate_cache=False))
    want = dense.generate([[1, 7, 300, 42]], 4)[0]
    assert sum(a == b for a, b in zip(toks, want)) >= 3


def test_auto_page_size(model):
    """One default page size for every geometry: one page is one block of
    the decode kernel, which wants a power of two of at least 16 keys;
    explicit values pass through."""
    ps = EngineConfig().page_size
    assert ps == 64 and ps & (ps - 1) == 0 and ps >= 16
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(max_seq_len=64, paged=True))
    assert eng.ecfg.page_size == 64
    eng = Engine(cfg, params, EngineConfig(max_seq_len=64, paged=True, page_size=16))
    assert eng.ecfg.page_size == 16
