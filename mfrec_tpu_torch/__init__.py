'''
mfrec_tpu_torch — the PyTorch/CUDA port of ``mfrec_tpu``.

The port runs beside the JAX package, which stays the reference it is
tested against.  It imports torch and numpy, never jax or mfrec_tpu.
What is ported so far:

* the serving slice: the ratings store, the checkpoint format,
  ``GDRecommender``'s predictors and batched top-N retrieval (the
  hand-written CUDA kernel K3 on a GPU, in ``csrc/topn.cu``), similarity
  search and the HTTP server;
* the training slice: ``GDRecommender.train()`` /
  ``feature_training_bias()`` on the single-device sorted-window
  alternating engine, whose batch step is the hand-written CUDA kernel
  K1 on a GPU (``csrc/half_pass.cu``);
* the WRMF/ALS slice: ``WRMFRecommender.train()`` on the single-device
  nnz-bucket half-sweeps, exact (batched Cholesky) or CG, whose PCG
  iterations are the hand-written CUDA kernel K2 on a GPU
  (``csrc/pcg.cu``), and ``eval.metrics.precision_recall``;
* the SVD++ and FN slice: ``GDRecommender.feature_training_implicit()``
  and ``FNRecommender.train()`` on the sorted-window tiers, whose
  aggregation phases are the hand-written CUDA kernel K4 on a GPU
  (``csrc/window_agg.cu``) around K1's half-passes.

Models take ``device='cuda'`` (default) or ``device='cpu'``.
'''

__version__ = '0.1.0'

from mfrec_tpu_torch.models.base import BaseRecommender, DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.serving import RecommenderServer
from mfrec_tpu_torch import interop

__all__ = ['BaseRecommender', 'DefaultRate', 'Error', 'MFRecommender',
           'GDRecommender', 'WRMFRecommender', 'FNRecommender',
           'RecommenderServer', 'interop']
