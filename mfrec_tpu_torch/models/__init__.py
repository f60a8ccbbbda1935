'''The port's recommender classes.'''
from mfrec_tpu_torch.models.base import BaseRecommender
from mfrec_tpu_torch.models.mf import MFRecommender
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.models.kmf import KMFRecommender

__all__ = ['BaseRecommender', 'MFRecommender', 'GDRecommender',
           'WRMFRecommender', 'FNRecommender', 'KMFRecommender']
