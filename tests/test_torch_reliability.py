"""PyTorch port: the reliability model (`core/reliability.py`, paper §V-D,
Fig 5a), a numpy copy of the reference's.

The reference's own checks (`tests/test_reliability.py`) run on the port,
and every output equals the reference's exactly on the same inputs: both
are numpy, so there is no tolerance."""
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.core import flashsim as jfs
from repro.core import reliability as jrel
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs import get_config
from repro_torch.core import reliability as rel
from repro_torch.core.flashsim import FlashDie, SystemConfig


def test_lifetime_pe_matches_paper():
    """§V-D: 65B-class model @3 tok/s, 5 years ≈ 143 TB ≈ 1K P/E."""
    out = rel.lifetime_pe_cycles(get_config("llama3.1-70b"))
    assert 100 < out["total_tb"] < 200
    assert 500 < out["pe_cycles"] < 2_000
    assert out["margin_ok"]


def test_early_blocks_accumulate_more_reads():
    """Fig 5a shape: early-context blocks see the most reads."""
    br = rel.simulate_request_reads(get_config("opt-30b"), 25_000, 25_000,
                                    16, FlashDie())
    assert len(br) > 2
    assert br[0] >= br[-1]
    assert np.all(np.diff(br) <= 1e-9)


def test_pgrd_reduction_factors():
    """§V-D: ≈128× (KVNAND-C) and ≈2560× (KVNAND-D) at k=8, 256B units."""
    f = rel.pgrd_reduction_factors(
        get_config("llama3.1-8b"),
        SystemConfig("x", "kvnand-d", 8, 8), abits=16)
    assert abs(f["kvnand_c"] - 128) < 1
    assert abs(f["kvnand_d"] - 2560) < 30


def test_block_allocator_invariants():
    alloc = rel.BlockAllocator(64, seed=1)
    seen = set()
    for _ in range(200):
        blocks = alloc.allocate(4)
        assert len(set(blocks.tolist())) == 4
        seen.update(blocks.tolist())
        alloc.record_request(blocks, np.full(4, 1e5))
    assert len(seen) > 32                        # wear-leveled spread
    assert alloc.utilization() > 0.9
    assert float(alloc.state.page_reads.max()) <= rel.READ_DISTURB_LIMIT


def test_constants_match_reference():
    assert rel.READ_DISTURB_LIMIT == jrel.READ_DISTURB_LIMIT
    assert rel.SLC_PE_BUDGET == jrel.SLC_PE_BUDGET


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_outputs_equal_reference(arch):
    """Every function of the model on the same arch and inputs: equal to
    the reference's, exactly."""
    cfg, jcfg = get_config(arch), jget(arch)
    for ctx in (128, 4096, 50_000):
        for abits in (4, 8, 16):
            assert rel.kv_pages_per_request(cfg, ctx, abits, FlashDie()) \
                == jrel.kv_pages_per_request(jcfg, ctx, abits,
                                             jfs.FlashDie())
    for n_in, n_out in ((1, 1), (100, 900), (25_000, 25_000)):
        np.testing.assert_array_equal(
            rel.simulate_request_reads(cfg, n_in, n_out, 16, FlashDie()),
            jrel.simulate_request_reads(jcfg, n_in, n_out, 16,
                                        jfs.FlashDie()))
    for variant, g1, g2 in (("kvnand-c", 16, 0), ("kvnand-d", 8, 8)):
        assert rel.pgrd_reduction_factors(
            cfg, SystemConfig("x", variant, g1, g2), abits=8) == \
            jrel.pgrd_reduction_factors(
                jcfg, jfs.SystemConfig("x", variant, g1, g2), abits=8)
    for kw in ({}, dict(tok_per_s=10.0, years=1.0, abits=8, n_dies=4)):
        assert rel.lifetime_pe_cycles(cfg, **kw) == \
            jrel.lifetime_pe_cycles(jcfg, **kw)


@pytest.mark.parametrize("seed", range(3))
def test_block_allocator_equals_reference(seed):
    """The same allocate / record sequence, read counts drawn past the
    read-disturb limit so blocks migrate and retire: the same blocks,
    wear state and utilization at every step."""
    rng = np.random.default_rng(seed)
    port, ref = rel.BlockAllocator(32, seed=seed), jrel.BlockAllocator(
        32, seed=seed)
    for _ in range(150):
        n = int(rng.integers(1, 9))
        reads = rng.uniform(0, 6e5, n)
        b_port, b_ref = port.allocate(n), ref.allocate(n)
        np.testing.assert_array_equal(b_port, b_ref)
        port.record_request(b_port, reads)
        ref.record_request(b_ref, reads)
        for f in ("page_reads", "pe_cycles", "retired"):
            np.testing.assert_array_equal(getattr(port.state, f),
                                          getattr(ref.state, f))
        assert port.utilization() == ref.utilization()
        assert port.state.max_reads == ref.state.max_reads
