"""The plain reference of the training layer against the program's step
(``collectives.transformer_step``) at a tiny size on the CPU, on one rank
and on four gloo ranks (dp 2 x mp 2), and its parts against the plainest
forms of their equations."""

import math

import pytest
import torch

from benchmark import compare
from benchmark.kinds import train
from benchmark.reference import layer as reference
from tpu_operator_torch.workloads import _ranks, collectives


def _inputs(tiny, cell, seed=11):
    config, traffic = tiny(cell)
    weights, xs = train.make_inputs(config, traffic, seed, torch.device("cpu"), 3)
    return config, traffic, weights, xs


def test_attention_in_blocks_is_plain_causal_softmax():
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 40, 8, dtype=torch.float64, requires_grad=True) for _ in range(3))
    out = reference.CausalAttention.apply(q, k, v, 16, False)
    s = q @ k.transpose(1, 2) / math.sqrt(8)
    s = s.masked_fill(torch.ones(40, 40).triu(1).bool(), float("-inf"))
    plain = torch.softmax(s, -1) @ v
    assert torch.allclose(out, plain, atol=1e-12)
    g = torch.randn_like(out)
    mine = torch.autograd.grad(out, (q, k, v), g)
    theirs = torch.autograd.grad(plain, (q, k, v), g)
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b, atol=1e-10)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-12, -(1.0 + 2**-11)])
    assert reference.to_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-10,
                                             -(1.0 + 2**-10)]


def test_one_rank_step_against_the_program(tiny):
    config, traffic, weights, xs = _inputs(tiny, "train.s2048.x1")
    mesh = collectives.make_mesh(1, 0, torch.device("cpu"))
    params = train.shard(weights, mesh)
    losses = []
    for x in xs:
        loss, params = collectives.transformer_step(mesh, config["n_heads"], params, x,
                                                    lr=config["lr"])
        losses.append(float(loss))
    ref = reference.train(weights, xs, config["n_heads"], config["lr"], rows=8)
    assert losses == pytest.approx(ref["losses"], rel=1e-6)
    for name in reference.LEAVES:
        change = float((params[name] - weights[name]).double().norm())
        assert change == pytest.approx(ref["change_norms"][name], rel=1e-4)


def _four_rank_readings(rank, n, device, config, traffic, seed):
    job = train.Job(rank, n, device, config, traffic, seed)
    losses, grads, change, _ = job.checked(3)
    views = train._share([grads, change], n)
    return train.readings(losses, views) if rank == 0 else None


def test_four_rank_step_against_the_reference(tiny):
    config, traffic, weights, xs = _inputs(tiny, "train.s2048.x4")
    program = _ranks.run(_four_rank_readings, 4, "cpu", config=config, traffic=traffic, seed=11)
    ref = reference.train(weights, xs, config["n_heads"], config["lr"], rows=8)
    gaps = compare.train_gaps(program, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4


def test_half_batch_leaves_half_out():
    assert reference.half_of(torch.zeros(4, 6, 2)).shape == (2, 6, 2)
    assert reference.half_of(torch.zeros(1, 6, 2)).shape == (1, 3, 2)


def test_gaps_take_the_worst_leaf_against_the_larger_norm():
    ref = {"losses": [2.0], "grad_norms": {"a": 1.0, "b": 4.0, "c": 1e-9},
           "change_norms": {"a": 1.0, "b": 4.0, "c": 5.0}}
    prog = {"losses": [2.002], "grad_norms": {"a": [1.1], "b": [4.0], "c": [2e-9]},
            "change_norms": {"a": [1.0], "b": [4.0], "c": [99.0]}}
    gaps = compare.train_gaps(prog, ref)
    assert gaps["loss_gap"] == pytest.approx(1e-3)
    assert gaps["grad_gap"] == pytest.approx(0.1)  # a's, over the median leaf's 1.0
    assert gaps["change_gap"] == 0.0  # c's reference gradient is quiet: not compared
    correct, compared = compare.verdict(gaps, {"loss_gap": 1e-2, "grad_gap": 1e-2})
    assert not correct and list(compared) == ["loss_gap", "grad_gap"]
