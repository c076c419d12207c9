"""The card channel's collectives (`onda_torch/parallel/shared_card.py`)
over host memory: ranks as threads of one process, each with its staging
buffer and every other's, meeting at the counters' barrier. Its sums and
gathers must equal the ranks' tensors added in rank order and stacked, for
tensors smaller than the buffer, as large, and several buffers long (the
pieces), in f32, f64 and int32. On the card the same code runs through CUDA
IPC buffers (chip_smoke.py's phase 13.0)."""

import threading

import numpy as np
import pytest
import torch

from onda_torch.parallel import shared_card

BUFFER = 64  # bytes: a tensor of 16 f32 fills it


def run_ranks(size, fn):
    """fn(rank's SharedCard) on `size` threads sharing buffers and counters;
    returns their results in rank order."""
    buffers = [torch.zeros(BUFFER, dtype=torch.uint8) for _ in range(size)]
    flags = np.zeros(size, dtype=np.int64)
    out, errors = [None] * size, []

    def rank(j):
        try:
            out[j] = fn(shared_card.SharedCard(j, buffers[j], buffers, flags))
        except Exception as exc:  # noqa: BLE001 - raised on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=rank, args=(j,)) for j in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "a rank never left the barrier"
    return out


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("n", [1, 7, 16, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_sum_and_gather_match_rank_order(size, n, dtype):
    gen = torch.Generator().manual_seed(1000 * size + n)
    xs = [(torch.randn(n, generator=gen, dtype=torch.float64) * 1e3).to(dtype)
          for _ in range(size)]
    want_sum = xs[0].clone()
    for x in xs[1:]:
        want_sum += x
    want_gather = torch.stack(xs)

    def both(card):
        x = xs[card.index]
        return card.all_sum(x.clone()), card.gather(x.view(1, n))

    for got_sum, got_gather in run_ranks(size, both):
        assert torch.equal(got_sum, want_sum)
        assert torch.equal(got_gather, want_gather.view(size, 1, n))


def test_calls_in_a_row_keep_the_barrier():
    """Calls of different sizes one after another on every rank: each sees
    its own call's parts, never the next call's."""
    sizes = (5, 40, 16, 3)

    def calls(card):
        return [card.all_sum(torch.full((n,), float(card.index + 1) * n)) for n in sizes]

    for got in run_ranks(2, calls):
        for n, y in zip(sizes, got):
            assert torch.equal(y, torch.full((n,), 3.0 * n))
