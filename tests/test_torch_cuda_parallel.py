"""The scale-out step on the card: a one-rank NCCL group, whose all-reduce
of the two VAD aggregates runs on the device, equals the step without a
group bit for bit. Needs a CUDA device and nvcc; skipped elsewhere. On a
machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_parallel.py
"""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import DetectionSettings, WHISPER_LARGE_V3
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.parallel import make_mesh, sharded_frontend_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 have no CPU mode)")
    return torch.device("cuda", 0)


def test_nccl_one_rank_step_equals_ungrouped(dev, tmp_path):
    import torch.distributed as dist

    x = torch.from_numpy((np.random.default_rng(5).normal(
        size=(8, 16000 * 5)) * 0.2).astype(np.float32)).to(dev)
    valid = np.asarray([80000, 40000, 0, 80000, 12345, 80000, 80000, 400],
                       np.int32)
    kw = dict(settings=DetectionSettings(), mel_config=WHISPER_LARGE_V3)
    want = sharded_frontend_step(make_mesh(device=dev), **kw)(x, valid)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert (mesh.size, mesh.rank, mesh.device) == (1, 0, dev)
        step = sharded_frontend_step(mesh, **kw)
        k1, k2 = sig_mel.launches, sig_multi.launches
        got = step(x, valid)
        torch.cuda.synchronize()
        assert (sig_mel.launches - k1, sig_multi.launches - k2) == (1, 1)
    finally:
        dist.destroy_process_group()
    for key, w in want.items():
        assert got[key].device == dev and torch.equal(got[key], w), key
