'''K3 on a CUDA device: the kernel against its plain twin, and a CUDA
model and server against the same model on the CPU.  Every case is
marked ``gpu`` and skips without a card.  This file imports no JAX, so
on a GPU host without it run it alone, without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: exact mode scores within 1e-4 (f32 sums in another order),
ids equal unless the twin's neighbouring scores lie within 1e-5; fast
mode within one quantization step (rtol 2^-10, atol 1e-5).'''
import numpy as np
import pytest
import torch

from mfrec_tpu_torch.ops.topn_kernel import (kernel_rated_lists,
                                             topn_agreement,
                                             topn_scores_kernel,
                                             topn_scores_ref)

pytestmark = pytest.mark.gpu
EXACT = dict(atol=1e-4, rtol=0.0, tie=1e-5)
FAST = dict(atol=1e-5, rtol=2.0 ** -10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _case(B, I, k, L, seed):
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.5, (B, k)).astype(np.float32)
    Q = rng.normal(0, 0.5, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.2, B).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    ridx = np.zeros((B, L), np.int32)
    for b in range(B):
        ridx[b] = np.sort(rng.choice(I, L, replace=False))
    return P, Q, bu, bi, ridx, np.ones((B, L), np.float32)


@pytest.mark.parametrize('fast', [False, True])
@pytest.mark.parametrize('shape', [(37, 3001, 64, 10, 40),
                                   (5, 300, 66, 7, 3),
                                   (21, 7000, 64, 32, 50),
                                   (21, 7000, 64, 33, 50),
                                   (19, 2000, 128, 1024, 90)])
def test_kernel_matches_twin(cuda, fast, shape):
    B, I, k, n, L = shape
    P, Q, bu, bi, ridx, rmask = _case(B, I, k, L, seed=B)
    ri, rc = kernel_rated_lists(ridx, rmask)
    args = [torch.from_numpy(a).to(cuda) for a in (P, Q, bu, bi)]
    r = [torch.from_numpy(a).to(cuda) for a in (ri, rc)]
    before = topn_scores_kernel.launches
    idx, s = topn_scores_kernel(*args, 3.5, n, *r, bf16_dot=fast,
                                packed=fast)
    torch.cuda.synchronize()
    assert topn_scores_kernel.launches == before + 1
    ref = topn_scores_ref(*args, 3.5, min(n + 1, I), *r, bf16_dot=fast,
                          packed=fast)
    ok, err, swaps = topn_agreement(idx.cpu(), s.cpu(), ref[0].cpu(),
                                    ref[1].cpu(), n,
                                    **(FAST if fast else EXACT))
    assert ok, (err, swaps)


@pytest.mark.parametrize('fast', [False, True])
def test_cuda_model_matches_cpu_model(cuda, fast):
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    u, i, v = synthetic_ratings(400, 300, 9000, rank=4, seed=1)
    rng = np.random.default_rng(2)
    P = rng.normal(0, 0.3, (400, 16)).astype(np.float32)
    Q = rng.normal(0, 0.3, (300, 16)).astype(np.float32)
    bu = rng.normal(0, 0.1, 400).astype(np.float32)
    bi = rng.normal(0, 0.1, 300).astype(np.float32)
    gpu, cpu = (interop.from_numpy(P, Q, bu, bi, 3.6, (u, i, v),
                                   device=d) for d in ('cuda', 'cpu'))
    users = np.arange(0, 400, 7)
    for pred in ('predict', 'predict_rating_with_bias'):
        before = topn_scores_kernel.launches
        got = gpu.recommend_batch(users, 10, predictor=pred, fast=fast)
        assert topn_scores_kernel.launches == before + 1
        ref = cpu.recommend_batch(users, 11, predictor=pred, fast=fast)
        ok, err, swaps = topn_agreement(*got, *ref, 10,
                                        **(FAST if fast else EXACT))
        assert ok, (pred, err, swaps)
