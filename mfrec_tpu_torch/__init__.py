'''
mfrec_tpu_torch — the PyTorch/CUDA port of ``mfrec_tpu``.

The port runs beside the JAX package, which stays the reference it is
tested against.  It imports torch and numpy, never jax or mfrec_tpu.
What is ported so far is the serving slice: the ratings store, the
checkpoint format, ``GDRecommender``'s predictors and batched top-N
retrieval (the hand-written CUDA kernel K3 on a GPU, in
``csrc/topn.cu``), similarity search and the HTTP server.  Models take
``device='cuda'`` (default) or ``device='cpu'``.  Training is not ported
yet.
'''

__version__ = '0.1.0'

from mfrec_tpu_torch.models.base import BaseRecommender, DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.serving import RecommenderServer
from mfrec_tpu_torch import interop

__all__ = ['BaseRecommender', 'DefaultRate', 'Error', 'MFRecommender',
           'GDRecommender', 'RecommenderServer', 'interop']
