'''
Carry a model's state from the JAX package into the port.

Both entry points take numpy only, so neither needs jax installed:

* ``load_jax_state(path, device)`` reads the files that
  ``mfrec_tpu``'s ``BaseRecommender.save_state(path)`` writes
  (``path``_state.npz + ``path``_state.json: ratings, ``svd_u``/``svd_v``,
  biases, ``extra_*`` arrays, labels and metadata);
* ``from_numpy(...)`` builds the same model from arrays.

Each returns a port ``GDRecommender`` that computes what the JAX model
computes.
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.engine import checkpoint as ckpt
from mfrec_tpu_torch.models.gd import GDRecommender


def load_jax_state(path, device='cuda'):
    '''A ``GDRecommender`` on ``device`` from a JAX-package checkpoint.'''
    _, _, metadata = ckpt.load_state(path)
    model = GDRecommender(int(metadata['nbr_users']),
                          int(metadata['nbr_items']), device=device)
    model.load_state(path)
    return model


def from_numpy(P, Q, users_bias, items_bias, overall_bias, ratings,
               labels=None, device='cuda'):
    '''A ``GDRecommender`` on ``device`` from arrays: ``P`` [users, k],
    ``Q`` [items, k], the biases (None for none), ``ratings`` as a
    ``(users, items, values)`` triple, and optional ``labels``
    ``{'users': [...], 'items': [...]}``.'''
    P = np.ascontiguousarray(P, np.float32)
    Q = np.ascontiguousarray(Q, np.float32)
    if P.ndim != 2 or Q.ndim != 2 or P.shape[1] != Q.shape[1]:
        raise ValueError('P [users, k] and Q [items, k] must share k')
    model = GDRecommender(P.shape[0], Q.shape[0],
                          {'nbr_features': P.shape[1]}, device=device)
    model.P, model.Q = P, Q
    if users_bias is not None:
        model.users_bias = np.asarray(users_bias, np.float32)
    if items_bias is not None:
        model.items_bias = np.asarray(items_bias, np.float32)
    model.overall_bias = None if overall_bias is None else float(overall_bias)
    model.set_ratings(*ratings)
    if labels:
        model.users.labels = list(labels['users'])
        model.items.labels = list(labels['items'])
        model.build_index()
    return model
