"""``chip_smoke.py``'s gather floor, on the CPU: the 32-byte sectors a
gathered row touches, counted on worked cases.  The floor beside each
bag and PNA site's bound is (row sectors x 32 + ids + output) at the
card's memory rate, so these counts are what it rests on."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("row_bytes,ids,want", [
    (300, [0, 1, 2], [10, 10, 11]),          # PNA: d 75 f32
    (300, list(range(8, 16)), [10, 10, 11, 10, 10, 11, 10, 10]),
    (40, [0, 1, 2, 3, 4, 999_999, 38_999_999], [2] * 7),   # bag: d 10 f32
    (20, [0, 1, 2, 3], [1, 2, 1, 2]),        # bag: d 10 bf16
    (512, [0, 5, 77], [16, 16, 16]),         # d 128 f32: whole sectors
    (300, [-1, 0, -1], [0, 10, 0]),          # padding touches nothing
])
def test_row_sectors_worked_cases(row_bytes, ids, want):
    got = chip_smoke.row_sectors(torch.tensor(ids, dtype=torch.int32),
                                 row_bytes)
    assert got.tolist() == want


def test_row_sectors_mean_at_d75_and_offset_base():
    """A 300-byte row repeats its sector pattern every 8 rows (2,400 B =
    75 sectors): 82 sectors per 8 rows, 10.25 per row.  A table that
    starts mid-sector shifts every row's span."""
    ids = torch.arange(8, dtype=torch.int32)
    assert int(chip_smoke.row_sectors(ids, 300).sum()) == 82
    assert chip_smoke.row_sectors(ids[:1], 40, base=28).tolist() == [3]
    assert chip_smoke.row_sectors(ids[:1], 40, base=24).tolist() == [2]


def test_gather_floor_bytes_counts_sectors_ids_and_output():
    """The floor's bytes: every valid slot's sectors (a row gathered
    twice counts twice), every id, and the output."""
    table = torch.zeros(50, 75)
    nbr = torch.tensor([[0, 1, -1], [2, 0, -1]], dtype=torch.int32)
    base = table.data_ptr() % chip_smoke.SECTOR
    sectors = int(chip_smoke.row_sectors(nbr, 300, base).sum())
    if base == 0:
        assert sectors == 10 + 10 + 11 + 10
    out_bytes = 2 * 4 * 75 * 4
    got = chip_smoke.gather_floor_bytes(table, nbr, out_bytes, chunk=4)
    assert got == sectors * 32 + nbr.numel() * 4 + out_bytes


@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_bitonic_work_counts_the_function(tile):
    """The bitonic site's bound reads the function, not a design: beside
    the candidate kernel's bytes, per posting lane Q products and Q adds,
    and per (query, doc) of a visited tile the 5-op tail and one compare,
    at any tile (no count of a network's stages)."""
    i32 = torch.int32
    num_docs, q, k_tile = 5000, 8, 16
    n_tiles = -(-num_docs // tile)
    pb = torch.tensor([0, 1, 1, 2, 0, 0], dtype=i32)
    pt = torch.tensor([0, 0, 2, 2, n_tiles, n_tiles], dtype=i32)
    args = (torch.zeros(3, 128, dtype=i32), torch.zeros(3, 128),
            pb, pt, torch.zeros(6, q), torch.zeros(6, dtype=i32),
            torch.zeros(num_docs), torch.zeros(num_docs), torch.ones(q),
            num_docs, k_tile)
    nbytes, ops, real, blocks, tiles = chip_smoke.bitonic_work(
        "hor", args, tile, q)
    assert (real, blocks, tiles) == (4, 3, 2)
    assert nbytes == chip_smoke.kernel_work("hor", args, tile, q)[0]
    assert ops == 3 * 128 * 2 * q + q * 2 * tile * 6


def test_signed_zero_docs_give_zeros_of_both_signs():
    """The edge calls' doc table, through the scoring tail at qnorm 1e30
    and rank_blend 0.5: positive scores, +0.0 and -0.0 (deleted docs
    -inf); a tile's last four zero docs are -0.0."""
    from repro_torch.core.query import final_scores
    tile, n = 512, 2048
    docs = chip_smoke.signed_zero_docs(n, tile, "cpu")
    final = final_scores(torch.ones(1, n), docs.norm, docs.rank,
                         torch.full((1,), 1e30), 0.5)[0]
    zero = final == 0
    assert bool((final > 0).any()) and int(zero.sum()) == n // 16
    assert bool(torch.signbit(final[zero]).any())
    assert bool((~torch.signbit(final[zero])).any())
    last = torch.arange(n) % tile >= tile - 64
    assert bool(torch.signbit(final[zero & last]).all())
    assert bool((final[(docs.norm == 0)] == float("-inf")).all())
