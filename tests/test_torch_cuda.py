"""The port's CUDA traversal kernel against its plain torch version, on
the card.  Every test here needs a CUDA device and nvcc; without them it
skips.  On a CUDA machine run them with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py boots the JAX package's CPU mesh,
which these tests do not use.)
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.serving import kernel, pack

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traversal kernel has no "
                    "CPU mode (the CPU path is tests/test_torch_serving.py)")
    return torch.device("cuda")


def _planes(rng, T, depth, F, dev):
    arrays = {"values": rng.normal(size=(T, 2 ** depth)).astype(np.float32)}
    for d in range(depth):
        w = 2 ** d
        arrays[f"feat_{d}"] = rng.integers(0, F, (T, w))
        arrays[f"thr_{d}"] = rng.normal(size=(T, w)).astype(np.float32)
        arrays[f"na_left_{d}"] = rng.integers(0, 2, (T, w)).astype(bool)
        arrays[f"valid_{d}"] = rng.random((T, w)) < 0.8
    return [torch.from_numpy(a).to(dev)
            for a in pack.pack_group(arrays, depth)]


@pytest.mark.parametrize("depth,T,F,B", [(0, 3, 4, 5), (3, 33, 7, 9),
                                         (6, 64, 40, 256), (10, 300, 32, 37),
                                         (12, 5, 1023, 17)])
def test_kernel_bitwise_equals_plain(cuda, depth, T, F, B):
    rng = np.random.default_rng(depth * 1000 + T)
    i32, f32, roots = _planes(rng, T, depth, F, cuda)
    X = rng.normal(size=(B, F)).astype(np.float32)
    X[rng.random((B, F)) < 0.1] = np.nan
    Xd = torch.from_numpy(X).to(cuda)
    before = kernel.TRAVERSE.launches
    got = kernel.traverse(i32, f32, roots, Xd, depth)
    want = kernel.traverse_torch(i32, f32, roots, Xd, depth)
    torch.cuda.synchronize()
    assert kernel.TRAVERSE.launches == before + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(), pack.traverse(i32.cpu().numpy(),
                                         f32.cpu().numpy(),
                                         roots.cpu().numpy(), X, depth))


def test_kernel_rejects_mixed_devices(cuda):
    rng = np.random.default_rng(1)
    i32, f32, roots = _planes(rng, 2, 2, 3, cuda)
    with pytest.raises(ValueError, match="X on"):
        kernel.traverse(i32, f32, roots, torch.zeros(4, 3), 2)
