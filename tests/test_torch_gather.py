"""K9, the grouped row gather of the minibatch shuffle, against the JAX
package's Pallas kernel (experimental/pallas_gather.py, interpret mode).

The port's plain version (what the wrapper runs on CPU tensors) must equal
the TPU kernel bit for bit: it is a copy.  The cases are those of
tests/test_pallas_gather.py: bf16 and f32 fields of several widths, a full
permutation at G=16, a prefix permutation and G=1.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.experimental import pallas_gather as jgather
from deep_tracking_control_tpu_torch.ops import cuda_gather


def _fields(rng, R, specs):
    out_j, out_t = {}, {}
    for name, (shape, dt) in specs.items():
        x = rng.normal(size=(R,) + shape).astype(np.float32)
        out_j[name] = jnp.asarray(x, dt)
        out_t[name] = torch.from_numpy(np.array(out_j[name].astype(
            jnp.float32))).to(torch.bfloat16 if dt == jnp.bfloat16
                              else torch.float32)
    return out_j, out_t


CASES = {
    "g16_full": (512, 16, None, dict(priv=((1389,), jnp.bfloat16),
                                     hist=((265,), jnp.bfloat16),
                                     obs=((53,), jnp.float32),
                                     mu=((12,), jnp.float32),
                                     val=((), jnp.float32))),
    "g1_prefix": (96, 1, 80, dict(a=((200,), jnp.float32),
                                  b=((3,), jnp.float32))),
    "g8_prefix": (128, 8, 12, dict(h=((33,), jnp.bfloat16),
                                   v=((), jnp.float32))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_permute_groups_matches_pallas(case):
    R, G, prefix, specs = CASES[case]
    rng = np.random.default_rng(len(case))
    jflat, tflat = _fields(rng, R, specs)
    perm = rng.permutation(R // G)[:prefix].astype(np.int32)
    want = jgather.permute_groups(jflat, jnp.asarray(perm), G, interpret=True)
    before = cuda_gather.permute_groups.launches
    got = cuda_gather.permute_groups(tflat, torch.from_numpy(perm).long(), G)
    assert cuda_gather.permute_groups.launches == before   # CPU: plain
    for k in specs:
        assert got[k].dtype == tflat[k].dtype
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_array_equal(
            got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32)),
            err_msg=k)


def test_wrapper_rejects_bad_input():
    x = {"a": torch.zeros(12, 3)}
    with pytest.raises(ValueError):                       # 12 rows, G=5
        cuda_gather.permute_groups(x, torch.arange(2), 5)
    with pytest.raises(ValueError):                       # int32 perm
        cuda_gather.permute_groups(x, torch.arange(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError):                       # 2-d perm
        cuda_gather.permute_groups(x, torch.zeros(1, 3, dtype=torch.long), 4)
