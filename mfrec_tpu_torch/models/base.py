'''
BaseRecommender — the part of the ``mfrec_tpu/models/base.py`` surface
that serving touches: data management, label maps, biases, factor
views, similarity search and persistence.

Host state (``P``, ``Q``, biases, the ratings store) stays numpy, as in
the JAX package; device work runs on the model's ``device``.  Factor
layout: row-major ``Q`` [items, k] / ``P`` [users, k], with the
reference's ``svd_u``/``svd_v`` ([k, n]) as transposed properties.
'''
from __future__ import annotations

import logging

import numpy as np
import torch

from mfrec_tpu_torch.data.ratings import Ratings, Vocab
from mfrec_tpu_torch.engine import checkpoint as ckpt
from mfrec_tpu_torch.ops import similarity as sim_ops


class Error(Exception):
    '''Library-wide exception (reference base.py:23).'''


class DefaultRate(float):
    '''A constructor-default learning rate the user never assigned.

    Float subclass: arithmetic, comparisons and serialization behave
    exactly like the underlying value, but training code can tell "still
    the constructor default" from an explicit assignment of the same
    number.'''
    __slots__ = ()


def resolve_device(device):
    '''``torch.device`` for a model: 'cuda' (default) or 'cpu'.  Asking
    for CUDA where there is none raises; nothing falls back.'''
    dev = torch.device(device)
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError('device must be cuda or cpu, got %s' % dev)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device='%s' asked for, but torch.cuda."
                           "is_available() is False (pass device='cpu' to "
                           'run on the CPU)' % device)
    return dev


class BaseRecommender(object):
    '''Recommendation engine core: sparse ratings store, label<->index maps,
    bias computation, similarity search, save/load.'''

    PARAMETERS_INDEX = {}

    _logger_name = 'mfrec_tpu_torch.recommender'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 device='cuda'):
        self.logger = logging.getLogger(self._logger_name)
        self.device = resolve_device(device)

        self.dimensionality = 40
        self.min_rating = 1.0
        self.max_rating = 5.0

        self.ratings = Ratings(int(nbr_users), int(nbr_items))
        self.users = Vocab(int(nbr_users), 'user')
        self.items = Vocab(int(nbr_items), 'item')

        # Factors, row-major: P=[users,k], Q=[items,k]; svd_s for SVD models.
        self.P = None
        self.Q = None
        self.svd_s = None
        self.Y = None                      # SVD++ implicit item factors

        self.users_bias = None
        self.items_bias = None
        self.overall_bias = None
        self.data_normalized = False

        self.metadata = {}
        self.rng = np.random.default_rng(0)

        if parameters:
            self.set_parameters(parameters)

    # ------------------------------------------------------------ plumbing
    @property
    def nbr_users(self):
        return len(self.users)

    @property
    def nbr_items(self):
        return len(self.items)

    # Reference-compatible index/label attributes
    @property
    def users_index(self):
        return self.users.index

    @property
    def users_label(self):
        return self.users.labels

    @property
    def items_index(self):
        return self.items.index

    @property
    def items_label(self):
        return self.items.labels

    # Reference-compatible factor views ([dim, n] transposed)
    @property
    def svd_u(self):
        return None if self.Q is None else np.asarray(self.Q).T

    @svd_u.setter
    def svd_u(self, value):
        self.Q = None if value is None else \
            np.ascontiguousarray(np.asarray(value, np.float32).T)

    @property
    def svd_v(self):
        return None if self.P is None else np.asarray(self.P).T

    @svd_v.setter
    def svd_v(self, value):
        self.P = None if value is None else \
            np.ascontiguousarray(np.asarray(value, np.float32).T)

    @property
    def items_feedback(self):
        return None if self.Y is None else np.asarray(self.Y).T

    @items_feedback.setter
    def items_feedback(self, value):
        self.Y = None if value is None else \
            np.ascontiguousarray(np.asarray(value, np.float32).T)

    def set_parameters(self, parameters):
        '''Map public parameter names to attributes (reference
        base.py:180-199); unknown key -> Error.  Explicitly-set
        attribute names are recorded in ``_explicit_params``.'''
        if not hasattr(self, '_explicit_params'):
            self._explicit_params = set()
        for k, v in parameters.items():
            try:
                attr = self.PARAMETERS_INDEX[k]
            except KeyError:
                raise Error('Wrong parameters')
            setattr(self, attr, v)
            self._explicit_params.add(attr)

    def seed(self, seed):
        '''Deterministic seeding for host random draws (factor init).'''
        self.rng = np.random.default_rng(seed)

    # ----------------------------------------------------------- ingestion
    def set_item_by_id(self, user_index, item_index, value):
        self.ratings.set(int(user_index), int(item_index), float(value))

    def set_ratings(self, users, items, values):
        '''Bulk ingest of (users, items, values) arrays.'''
        self.ratings.set_many(users, items, values)

    def build_index(self):
        self.users.rebuild()
        self.items.rebuild()

    def add_user(self, label):
        '''Append a user (no ratings); returns its index.'''
        new_id = self.users.add(label)
        self.ratings.grow(nbr_users=new_id + 1)
        return new_id

    def add_item(self, label):
        '''Append an item (no ratings); returns its index.'''
        new_id = self.items.add(label)
        self.ratings.grow(nbr_items=new_id + 1)
        return new_id

    def get_ratings(self, randomize_order=False, seed=None):
        '''The ratings as (ratings_index [N, 2] int32, ratings [N]
        float64), shuffled from ``self.rng`` (or ``seed``) on request
        (reference base.py:1115-1131).'''
        if randomize_order:
            if seed is None:
                seed = int(self.rng.integers(2 ** 31))
            u, i, v = self.ratings.shuffled(seed)
        else:
            u, i, v = self.ratings.coo()
        idx = np.stack([u, i], axis=1).astype(np.int32)
        return idx, v.astype(np.float64)

    def _store_cached(self, name, build, *key):
        '''``build()``, kept on the model as ``name`` and keyed on the
        ratings store's identity token, snapshot ``version`` and nnz (+
        ``key``): a call on an unchanged store gets it back.  The token
        keeps a store swapped in by ``load_state``, whose version restarts
        at 0, from reusing another store's entry; the old entry is let go
        before a new one is built, so the device never holds two.  Returns
        ``(value, reused)``.'''
        store = self.ratings
        key = (store.token, store.version, store.nnz) + key
        cached = getattr(self, name, None)
        if cached is not None and cached[0] == key:
            return cached[1], True
        setattr(self, name, None)
        value = build()
        setattr(self, name, (key, value))
        return value, False

    def initialize_rated_feedback(self):
        '''Build the (rated [N,2], per-user (seek, span)) arrays consumed by
        the SVD++ path (reference base.py:228-263).'''
        u, i, _ = self.ratings.coo()
        self.feedback_rated = np.stack([u, i], 1).astype(np.int32)
        ptr = self.ratings.csr()[0]
        seek = ptr[:-1].astype(np.int32)
        span = np.diff(ptr).astype(np.int32)
        empty = span == 0
        seek[empty] = -1
        span[empty] = -1
        self.feedback_hash = np.stack([seek, span], 1)

    def initialize_bias(self):
        self.items_bias = np.zeros(self.nbr_items, np.float32)
        self.users_bias = np.zeros(self.nbr_users, np.float32)

    # -------------------------------------------------------------- biases
    def compute_overall_avg(self):
        self.overall_bias = self.ratings.overall_avg()

    def users_average(self, user_label):
        u = self.users.index[user_label]
        ptr, _, vals = self.ratings.csr()
        seg = vals[ptr[u]:ptr[u + 1]]
        return float(seg.mean())

    def items_average(self, item_label):
        i = self.items.index[item_label]
        ptr, _, vals = self.ratings.csc()
        seg = vals[ptr[i]:ptr[i + 1]]
        return float(seg.mean())

    def baseline_predictor(self, user_label, item_label):
        '''Item mean, falling back to user mean (base.py:444-458).'''
        try:
            return self.items_average(item_label)
        except (KeyError, ValueError):
            return self.users_average(user_label)

    # ---------------------------------------------------------- similarity
    @staticmethod
    def _apply_threshold(ids, sims, similarity_threshold):
        if similarity_threshold is False or similarity_threshold is None:
            return ids, sims
        keep = sims > similarity_threshold
        return ids[keep], sims[keep]

    def _similar_topk(self, F, index, nbr, similarity_threshold,
                      similarities_output, method, exclude_self=True):
        F = torch.from_numpy(np.ascontiguousarray(F, np.float32)).to(
            self.device)
        n = F.shape[0]
        if nbr == 'All':
            nbr = n - 1 if exclude_self else n
        k = min(int(nbr) + 0, n - 1 if exclude_self else n)
        idx, sims = sim_ops.similar_topk(
            F, torch.tensor([int(index)], device=self.device), max(k, 1),
            method=method, exclude_self=exclude_self)
        ids = idx[0].cpu().numpy()
        sims = sims[0].cpu().numpy().astype(np.float64)
        ids, sims = self._apply_threshold(ids, sims, similarity_threshold)
        ids, sims = ids[:nbr], sims[:nbr]
        if not similarities_output:
            return [int(x) for x in ids]
        return [int(x) for x in ids], [float(x) for x in sims]

    def similar_users(self, user_index, nbr_recommendations=2,
                      similarity_threshold=False, similarities_output=False,
                      method='pearson'):
        '''Nearest users in factor space (reference base.py:1294-1347).'''
        if self.P is None:
            raise Error('No user factors: train the model first')
        F = np.asarray(self.P, np.float32)[:, :self.dimensionality]
        return self._similar_topk(F, int(user_index), nbr_recommendations,
                                  similarity_threshold, similarities_output,
                                  method)

    def similar_items(self, item_index, nbr_recommendations=2,
                      similarity_threshold=False, similarities_output=False,
                      method='cosine'):
        '''Nearest items in factor space (reference base.py:1420-1466).'''
        F = np.asarray(self.Q, np.float32)
        return self._similar_topk(F, int(item_index), nbr_recommendations,
                                  similarity_threshold, similarities_output,
                                  method)

    # ----------------------------------------------------------- persistence
    def _extra_state_arrays(self):
        '''Model-specific extra factor arrays to checkpoint.'''
        return {}

    def save_state(self, filename):
        '''Full state: ratings + factors + label maps, in the JAX
        package's format (``filename``_state.npz + _state.json).'''
        u, i, v = self.ratings.coo()
        ckpt.save_state(
            filename,
            arrays={'ratings_u': u, 'ratings_i': i, 'ratings_v': v,
                    'svd_u': self.svd_u, 'svd_v': self.svd_v,
                    'svd_s': self.svd_s, 'users_bias': self.users_bias,
                    'items_bias': self.items_bias,
                    'items_feedback': self.items_feedback,
                    **{'extra_' + k: v2
                       for k, v2 in self._extra_state_arrays().items()}},
            labels={'users': self.users.to_list(),
                    'items': self.items.to_list()},
            metadata={**self.metadata,
                      'nbr_users': self.nbr_users,
                      'nbr_items': self.nbr_items,
                      'dimensionality': self.dimensionality,
                      'overall_bias': self.overall_bias,
                      'data_normalized': self.data_normalized})

    def load_state(self, filename):
        arrays, labels, metadata = ckpt.load_state(filename)
        nbr_users = int(metadata['nbr_users'])
        nbr_items = int(metadata['nbr_items'])
        self.users = Vocab(0, 'user')
        self.items = Vocab(0, 'item')
        self.users.labels = list(labels['users'])
        self.items.labels = list(labels['items'])
        self.users.rebuild()
        self.items.rebuild()
        self.ratings = Ratings(nbr_users, nbr_items)
        self.ratings.set_many(arrays['ratings_u'], arrays['ratings_i'],
                              arrays['ratings_v'])
        for name in ('svd_u', 'svd_v', 'svd_s', 'users_bias', 'items_bias',
                     'items_feedback'):
            if name in arrays:
                setattr(self, name, arrays[name])
        for name, val in arrays.items():
            if name.startswith('extra_'):
                setattr(self, name[len('extra_'):], val)
        self.dimensionality = int(metadata.get('dimensionality', 40))
        self.overall_bias = metadata.get('overall_bias')
        self.data_normalized = bool(metadata.get('data_normalized', False))

    def save_model_snapshot(self, filename):
        ckpt.save_model_snapshot(filename, self.svd_u, self.svd_v)

    def load_model_snapshot(self, filename):
        svd_u, svd_v = ckpt.load_model_snapshot(filename)
        self.svd_u, self.svd_v = svd_u, svd_v

    # --------------------------------------------------------------- stubs
    def train(self):
        pass

    def predict(self):
        pass
