"""chip_smoke.py's byte count for kernels B and C (gin_bytes / gin_bound),
on a hand-built bank on the CPU: it counts the x rows of adj's used
columns, the g rows of its used rows, and every other input and output
once in full."""

import pytest
import torch

import chip_smoke

N, H = 4, 8
F32 = 4


def bank(empty: int):
    """Two graphs plus `empty` graphs without a bond. Graph 0 is the chain
    0-1-2, both ways: columns and rows {0, 1, 2}. Graph 1 has the directed
    bonds 0->2 and 0->3: columns {2, 3}, row {0}."""
    b = 2 + empty
    adj = torch.zeros(b, N, N)
    for i, j in ((0, 1), (1, 0), (1, 2), (2, 1)):
        adj[0, i, j] = 1.0
    adj[1, 0, 2] = adj[1, 0, 3] = 1.0
    edge = (adj * 2).to(torch.int32)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, N, H, generator=gen)
    table = torch.randn(5, H, generator=gen)
    g = torch.randn(b, N, H, generator=gen)
    return x, edge, adj, table, g


def hand_count(empty: int, backward: bool) -> int:
    b = 2 + empty
    x_rows = (3 + 2) * H * F32
    edge = adj = b * N * N * F32
    table = 5 * H * F32
    out = b * N * H * F32                  # out (B) or dx (C)
    total = x_rows + edge + adj + table + out
    if backward:
        total += (3 + 1) * H * F32         # g rows
        total += 5 * H * F32               # dtable
    return total


@pytest.mark.parametrize("backward", [False, True], ids=["B", "C"])
def test_gin_bytes_equal_a_hand_count(backward):
    args = bank(3)
    assert chip_smoke.gin_bytes(args, backward) == hand_count(3, backward)
    bound_ms, bound_by = chip_smoke.gin_bound(args, backward)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(hand_count(3, backward)
                                     / chip_smoke.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("backward", [False, True], ids=["B", "C"])
def test_empty_graphs_add_only_adj_edge_and_output(backward):
    added = 5
    more = chip_smoke.gin_bytes(bank(3 + added), backward)
    fewer = chip_smoke.gin_bytes(bank(3), backward)
    per_graph = N * N * F32 + N * N * F32 + N * H * F32   # adj, edge, out
    assert more - fewer == added * per_graph


def test_b_and_c_differ_by_g_rows_dx_and_dtable():
    args = bank(3)
    b, c = (chip_smoke.gin_bytes(args, bwd) for bwd in (False, True))
    out = dx = 5 * N * H * F32
    g_rows = (3 + 1) * H * F32
    dtable = 5 * H * F32
    assert c - b == g_rows + dx + dtable - out
