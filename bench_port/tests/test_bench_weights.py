"""The benchmark's weights (harness/weights.py): the decoder's draws as
the rule before the recurrent cells had scales of their own, bit for bit,
and the cells' hidden layers at the scale of an orthogonal init of gain
1."""
import math

import pytest
import torch

from harness import weights
from harness.check import Reference
from test_bench_counts import POLICIES, with_policy

SEED = 2 ** 31 + 5


def first_rule(shapes: dict, seed: int, init_noise_std: float) -> dict:
    """The draw as it was for the decoder: an MLP's first layer clipped
    over sqrt(fan_in), every other matrix at gain 0.01."""
    names = sorted(shapes)
    mats = [n for n in names if len(shapes[n]) == 2]
    z = torch.randn(sum(math.prod(shapes[n]) for n in mats),
                    generator=torch.Generator().manual_seed(seed))
    out, i = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        if len(shape) == 2:
            fan_out, fan_in = shape
            w = z[i:i + fan_out * fan_in].view(shape)
            i += fan_out * fan_in
            out[n] = (w.clamp(-2.0, 2.0) / math.sqrt(fan_in)
                      if n.endswith("layers.0.weight")
                      else w * (0.01 / math.sqrt(max(fan_in, fan_out))))
        elif n == "std":
            out[n] = torch.full(shape, float(init_noise_std))
        else:
            out[n] = torch.zeros(shape)
    return out


def net_of(cfg: dict):
    return Reference(cfg, dict(num_envs=16), SEED, "cpu").make_net()


@pytest.mark.parametrize("name", ["lite3_dtc", "x30_dtc"])
def test_decoder_weights_unchanged(name):
    shapes = weights.shapes_of(net_of(with_policy(name)))
    got = weights.draw(shapes, SEED, 1.0, "cpu")
    want = first_rule(shapes, SEED, 1.0)
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("policy", ["gru", "lstm"])
def test_recurrent_cell_scales(policy):
    cfg = with_policy("lite3_dtc", **POLICIES[policy])
    w = weights.draw(weights.shapes_of(net_of(cfg)), SEED, 1.0, "cpu")
    H = cfg["train"]["policy"]["rnn_hidden_size"]
    hidden = [n for n in w if ".cell.h" in n and n.endswith(".weight")]
    inputs = [n for n in w if ".cell.i" in n and n.endswith(".weight")]
    gates = {"gru": 3, "lstm": 4}[policy]
    assert len(hidden) == len(inputs) == 2 * gates
    for n in hidden:
        assert w[n].shape == (H, H)
        rows = w[n].norm(dim=1)
        assert float(rows.square().mean()) == pytest.approx(1.0, abs=0.02)
        assert float((rows - 1).abs().max()) < 0.25, n
    for n in inputs:
        # a unit normal clamped at 2 (std 0.9626) over sqrt(fan_in)
        fan_in = w[n].shape[1]
        assert float(w[n].abs().max()) <= 2.0 / math.sqrt(fan_in) + 1e-7
        assert float(w[n].std() * math.sqrt(fan_in)) == pytest.approx(
            0.9626, abs=0.02)
    # the heads keep the MLP rule: first layer clipped, the rest small
    assert float(w["actor.layers.1.weight"].abs().max()) < 0.01
