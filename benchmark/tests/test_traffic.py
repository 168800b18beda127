"""Traffic generators repeat from a seed, and every seed sends the same work."""

import torch

from benchmark.loops import serve


def _seq(seed, blocks=6):
    g = torch.Generator().manual_seed(seed)
    sizes = [1024, 2048, 4096, 8192]
    seq = [m for _ in range(blocks) for m in serve.block(sizes, g, torch)]
    return seq, serve.kept(seq, sizes, 2, blocks, g, torch)


def test_the_same_seed_gives_the_same_batches_and_answers_kept():
    assert _seq(2**31 + 5) == _seq(2**31 + 5)
    assert _seq(1)[0] != _seq(2)[0]


def test_every_block_holds_each_size_once():
    seq, keep = _seq(7)
    for i in range(0, len(seq), 4):
        assert sorted(seq[i:i + 4]) == [1024, 2048, 4096, 8192]
    assert len(keep) == 8
    assert sorted(seq[i] for i in keep) == [1024, 1024, 2048, 2048, 4096, 4096, 8192, 8192]


def test_training_data_repeats_from_its_seed():
    from benchmark.harness import regression_data

    a = regression_data(torch, 50, 3, 0.1, torch.Generator().manual_seed(3), "cpu")
    b = regression_data(torch, 50, 3, 0.1, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
