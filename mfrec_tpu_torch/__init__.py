'''
mfrec_tpu_torch — the PyTorch/CUDA port of ``mfrec_tpu``.

The port runs beside the JAX package, which stays the reference it is
tested against.  It imports torch and numpy, never jax or mfrec_tpu.
Each TPU kernel of the JAX package, and each sequential loop that a CUDA
model cannot run as torch ops, is a CUDA kernel written by hand for
Hopper (``csrc/``, built with nvcc at first use), with a plain PyTorch
version beside it that CPU tensors run.  What is ported so far:

* serving: the ratings store, the checkpoint format, the predictors and
  batched top-N retrieval (K3, ``csrc/topn.cu``; a predictor without a
  score mode scores every unrated item on the host), similarity search
  and the HTTP server;
* ``GDRecommender``: ``train()`` on the sorted-window alternating engine,
  whose batch step is K1 (``csrc/half_pass.cuh``, four builds: link x the
  fixed side's type); the ``'fused'`` and ``'funk_fused'`` mini-batch
  engines (fixed-order scatter-adds); ``'funk'``, the fold-ins and the
  reference's main workflow through S1 (``csrc/serial_funk.cu``);
  ``feature_training_implicit()`` (SVD++), whose aggregation phases are
  K4 (``csrc/window_agg.cu``) around K1; evaluation and the sweeps;
* ``WRMFRecommender.train()`` on the nnz-bucket half-sweeps, one fused K2
  launch a bucket (``csrc/cg_bucket.cu``; its PCG in ``csrc/pcg.cuh``,
  shared with the M-given entry ``csrc/pcg.cu``), and
  ``eval.metrics.precision_recall``;
* ``FNRecommender.train()`` through K1 and K4, or its mini-batch tier;
* ``KMFRecommender``: the alternating engine through K1's logistic and
  identity builds with an f32 fixed side, the mini-batch engine, and
  ``engine='serial'`` and every fold-in through S2
  (``csrc/kmf_serial.cu``);
* the probe tools (``tools.ab_kernel``, ``tools.kernel_probe``) through
  P1 (``csrc/half_pass_old.cu``) and P2 (``csrc/probe.cu``).

Models take ``device='cuda'`` (default) or ``device='cpu'``: a CUDA model
always runs the kernels, a CPU model their plain versions.
'''

__version__ = '0.1.0'

from mfrec_tpu_torch.models.base import BaseRecommender, DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.models.kmf import KMFRecommender
from mfrec_tpu_torch.serving import RecommenderServer
from mfrec_tpu_torch import interop

__all__ = ['BaseRecommender', 'DefaultRate', 'Error', 'MFRecommender',
           'GDRecommender', 'WRMFRecommender', 'FNRecommender',
           'KMFRecommender', 'RecommenderServer', 'interop']
