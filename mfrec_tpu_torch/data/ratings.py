'''
Host-side ratings containers.

The reference stores ratings in a ``scipy.sparse.lil_matrix`` and converts
per-call via python iterators (``base.py:266,284,1115``).
Here the canonical representation is a flat COO triple of numpy arrays —
the layout the device kernels consume directly — with CSR/CSC row pointers and
padded-bucket layouts derived (and cached) on demand.

Copied from ``mfrec_tpu/data/ratings.py`` (that package imports jax).
The two stable sorts use numpy's stable argsort, the original's own
fallback for its C++ counting sort, which gives the same permutation.
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.utils import profiling


def create_bool_sparse_row(ratings):
    """Row-based (count-with-leading-0, col-index) boolean layout for the
    WRMF kernel feed (reference ``mfrec/lib/datasets.py:13-21``)."""
    u, i, _ = ratings.coo()
    counts = np.bincount(u, minlength=ratings.nbr_users).astype(np.int32)
    return np.r_[np.int32(0), counts], i.astype(np.int32)


def create_bool_sparse_col(ratings):
    """Column-based variant (reference ``mfrec/lib/datasets.py:24-32``)."""
    u, i, _ = ratings.coo()
    order = np.argsort(i, kind='stable')
    counts = np.bincount(i, minlength=ratings.nbr_items).astype(np.int32)
    return np.r_[np.int32(0), counts], u[order].astype(np.int32)


def padded_segment_gather(ptr, rows, L, *arrays):
    '''Vectorized padded CSR-segment gather — the shared core of every
    host-side padded-list layout (VERDICT r4 #5: this used to live as
    three drifting copies in ``ops.fn.padded_user_lists``,
    ``ops.topk.pad_rated_lists`` and ``Ratings.padded_rows``).

    For each row ``r`` in ``rows`` take up to ``L`` entries of its
    ``[ptr[r], ptr[r+1])`` segment from each array in ``arrays``
    (zero-filled beyond the row's count).  Returns one ``[R, L]`` array
    per input — integer inputs come back int32, floats float32 — plus
    the float32 validity mask.  The ``L`` policy (cap, power-of-two
    round-up, fixed serving width, nnz buckets) stays at the call sites;
    their contracts differ deliberately and are pinned by their tests.
    '''
    rows = np.asarray(rows, np.int64)
    counts = ptr[rows + 1] - ptr[rows]
    cnts = np.minimum(counts, L)[:, None]               # [R, 1]
    offs = np.arange(L, dtype=np.int64)[None, :]        # [1, L]
    mask = offs < cnts
    # grid of flat CSR positions, clamped to each row's segment (and to
    # the array end for zero-count rows); masked slots multiply to 0
    grid = ptr[rows][:, None] + np.minimum(offs, np.maximum(cnts - 1, 0))
    n = int(arrays[0].shape[0]) if arrays else 0
    grid = np.minimum(grid, max(n - 1, 0))
    outs = []
    for a in arrays:
        dt = np.int32 if a.dtype.kind in 'iu' else np.float32
        if n == 0:
            outs.append(np.zeros(mask.shape, dt))
        else:
            outs.append((a[grid] * mask).astype(dt))
    return tuple(outs) + (mask.astype(np.float32),)


class Vocab:
    '''Bidirectional label<->index map (reference: ``base.py:101-105,839-851``).

    Labels default to ``prefix0..prefixN-1`` like the reference's
    ``initialize_relationship_matrix`` (``base.py:275-281``).
    '''

    def __init__(self, n=0, prefix='id'):
        self.prefix = prefix
        self.labels = [prefix + str(i) for i in range(n)]
        self.index = {lbl: i for i, lbl in enumerate(self.labels)}

    def __len__(self):
        return len(self.labels)

    def __contains__(self, label):
        return label in self.index

    def add(self, label=None):
        '''Append a new id; returns the new index.'''
        new_id = len(self.labels)
        if label is None:
            label = self.prefix + str(new_id)
        self.labels.append(label)
        self.index[label] = new_id
        return new_id

    def set_label(self, idx, label):
        '''Rename an existing index (reference: ``base.py:1097-1112``).'''
        old = self.labels[idx]
        if old in self.index:
            del self.index[old]
        self.labels[idx] = label
        self.index[label] = idx

    def rebuild(self):
        self.index = {lbl: i for i, lbl in enumerate(self.labels)}

    def to_list(self):
        return list(self.labels)


class Ratings:
    '''Mutable COO ratings store with cached derived layouts.

    Mutation (``set``) invalidates caches; all bulk consumers
    (``coo``/``csr``/``csc``/``padded_rows``) operate on the deduplicated,
    user-major sorted snapshot.
    '''

    def __init__(self, nbr_users, nbr_items):
        self.nbr_users = int(nbr_users)
        self.nbr_items = int(nbr_items)
        self._users = []          # pending scalar appends
        self._items = []
        self._values = []
        self._bulk = []           # pending array appends
        self._u = np.zeros(0, np.int32)   # consolidated arrays
        self._i = np.zeros(0, np.int32)
        self._v = np.zeros(0, np.float32)
        self._dirty = False
        self._cache = {}
        # Monotone mutation counter: bumped whenever the consolidated
        # snapshot changes (consolidation of pending writes, grow).
        # Consumers cache derived layouts (e.g. the alternating engine's
        # sorted-pass layouts) keyed on ``version`` so repeated train()
        # calls on unchanged data skip the O(nnz) host re-sort.
        self._version = 0
        # Identity of this store for those caches: a fresh store (e.g.
        # from load_state) restarts ``version`` at 0, so the version alone
        # could match a cache built from another store.  An object, not
        # id(self): a cache that holds the token keeps it from being
        # reused, where an id() can be handed to a later object.
        self.token = object()

    @property
    def version(self):
        '''Stable snapshot id: consolidates pending writes first, so two
        reads with no interleaving mutation always agree.'''
        self._consolidate()
        return self._version

    # ------------------------------------------------------------- mutation
    def set(self, user_index, item_index, value):
        user_index, item_index = int(user_index), int(item_index)
        # bounds-check at write time like the reference's lil_matrix
        # (base.py set_rating raises IndexError); an out-of-range key
        # would otherwise reach the native counting sort, whose count
        # array is sized nbr_users/nbr_items — an out-of-bounds write
        if not (0 <= user_index < self.nbr_users
                and 0 <= item_index < self.nbr_items):
            raise IndexError(
                'rating (%d, %d) out of range for %d users x %d items'
                % (user_index, item_index, self.nbr_users, self.nbr_items))
        self._users.append(user_index)
        self._items.append(item_index)
        self._values.append(float(value))
        self._dirty = True

    def set_many(self, users, items, values):
        users = np.asarray(users, np.int32)
        items = np.asarray(items, np.int32)
        values = np.asarray(values, np.float32)
        if not (users.shape == items.shape == values.shape):
            raise ValueError('users/items/values must have identical shapes')
        if users.size and (
                int(users.min()) < 0 or int(users.max()) >= self.nbr_users
                or int(items.min()) < 0
                or int(items.max()) >= self.nbr_items):
            raise IndexError(
                'ratings out of range for %d users x %d items '
                '(got users [%d, %d], items [%d, %d])'
                % (self.nbr_users, self.nbr_items, users.min(), users.max(),
                   items.min(), items.max()))
        # bulk appends stay as arrays (no python-object round trip);
        # flush any pending scalar appends first to preserve write order
        # (last write wins, chronologically)
        self._flush_scalars()
        self._bulk.append((users, items, values))
        self._dirty = True

    def _flush_scalars(self):
        if self._users:
            self._bulk.append((np.asarray(self._users, np.int32),
                               np.asarray(self._items, np.int32),
                               np.asarray(self._values, np.float32)))
            self._users, self._items, self._values = [], [], []

    def grow(self, nbr_users=None, nbr_items=None):
        if nbr_users is not None:
            self.nbr_users = max(self.nbr_users, int(nbr_users))
        if nbr_items is not None:
            self.nbr_items = max(self.nbr_items, int(nbr_items))
        self._cache = {}
        self._version += 1

    def _consolidate(self):
        if not self._dirty:
            return
        with profiling.span('store.consolidate'):
            u = np.concatenate([self._u] + [b[0] for b in self._bulk]
                               + [np.asarray(self._users, np.int32)])
            i = np.concatenate([self._i] + [b[1] for b in self._bulk]
                               + [np.asarray(self._items, np.int32)])
            v = np.concatenate([self._v] + [b[2] for b in self._bulk]
                               + [np.asarray(self._values, np.float32)])
            self._bulk = []
            # Sort user-major (u, then i): two stable sort passes.
            perm_i = np.argsort(i, kind='stable')
            u2, i2, v2 = u[perm_i], i[perm_i], v[perm_i]
            perm_u = np.argsort(u2, kind='stable')
            u, i, v = u2[perm_u], i2[perm_u], v2[perm_u]
            # Deduplicate: last write wins (lil_matrix assignment semantics).
            keep = np.ones(u.shape[0], bool)
            keep[:-1] = (u[:-1] != u[1:]) | (i[:-1] != i[1:])
            # An explicit zero deletes the entry (sparse-store semantics).
            keep &= v != 0.0
            self._u, self._i, self._v = u[keep], i[keep], v[keep]
            self._users, self._items, self._values = [], [], []
            self._dirty = False
            self._cache = {}
            self._version += 1

    # ------------------------------------------------------------ accessors
    @property
    def nnz(self):
        self._consolidate()
        return int(self._v.shape[0])

    def coo(self):
        '''User-major sorted (user_idx[N], item_idx[N], value[N]).'''
        self._consolidate()
        return self._u, self._i, self._v

    def get(self, user_index, item_index):
        '''O(log nnz_row) point lookup: binary search within the user's
        CSR segment (the per-prediction hot path of the kNN predictors —
        a full-COO scan here was O(nnz) per call).'''
        ptr, items, vals = self.csr()
        s, e = int(ptr[user_index]), int(ptr[user_index + 1])
        pos = s + int(np.searchsorted(items[s:e], item_index))
        if pos < e and items[pos] == item_index:
            return float(vals[pos])
        return 0.0

    def shuffled(self, seed=0):
        '''COO triple in a deterministic shuffled order (explicit seed —
        replaces the reference's global ``np.random.shuffle`` at
        ``base.py:1128-1129``).'''
        u, i, v = self.coo()
        perm = np.random.default_rng(seed).permutation(u.shape[0])
        return u[perm], i[perm], v[perm]

    def csr(self):
        '''(row_ptr[U+1], item_idx[nnz], value[nnz]) sorted by user.'''
        self._consolidate()
        if 'csr' not in self._cache:
            counts = np.bincount(self._u, minlength=self.nbr_users)
            ptr = np.zeros(self.nbr_users + 1, np.int64)
            np.cumsum(counts, out=ptr[1:])
            # share the consolidated arrays: every mutation path
            # reassigns self._i/_v and clears _cache, so the cached view
            # can never be invalidated in place — copying here doubled
            # transient host memory (~0.8 GB at the Netflix 100M stream)
            self._cache['csr'] = (ptr, self._i, self._v)
        return self._cache['csr']

    def csc(self):
        '''(col_ptr[I+1], user_idx[nnz], value[nnz]) sorted by item.'''
        self._consolidate()
        if 'csc' not in self._cache:
            order = np.argsort(self._i, kind='stable')
            items = self._i[order]
            counts = np.bincount(items, minlength=self.nbr_items)
            ptr = np.zeros(self.nbr_items + 1, np.int64)
            np.cumsum(counts, out=ptr[1:])
            self._cache['csc'] = (ptr, self._u[order], self._v[order])
        return self._cache['csc']

    def user_counts(self):
        self._consolidate()
        return np.bincount(self._u, minlength=self.nbr_users)

    def item_counts(self):
        self._consolidate()
        return np.bincount(self._i, minlength=self.nbr_items)

    def to_dense(self):
        self._consolidate()
        m = np.zeros((self.nbr_users, self.nbr_items), np.float32)
        m[self._u, self._i] = self._v
        return m

    def rated_mask_for_user(self, user_index):
        ptr, items, _ = self.csr()
        mask = np.zeros(self.nbr_items, bool)
        mask[items[ptr[user_index]:ptr[user_index + 1]]] = True
        return mask

    # --------------------------------------------------------- statistics
    def overall_avg(self):
        self._consolidate()
        return float(self._v.mean()) if self._v.size else 0.0

    def user_means(self, default=0.0):
        self._consolidate()
        counts = self.user_counts()
        sums = np.bincount(self._u, weights=self._v, minlength=self.nbr_users)
        with np.errstate(invalid='ignore', divide='ignore'):
            means = sums / counts
        means[counts == 0] = default
        return means.astype(np.float32)

    def item_means(self, default=0.0):
        self._consolidate()
        counts = self.item_counts()
        sums = np.bincount(self._i, weights=self._v, minlength=self.nbr_items)
        with np.errstate(invalid='ignore', divide='ignore'):
            means = sums / counts
        means[counts == 0] = default
        return means.astype(np.float32)

    # ----------------------------------------------------- padded layouts
    def padded_rows(self, axis='user', buckets=(8, 16, 32, 64, 128, 256,
                                                512,
                                                1024, 2048, 4096, 8192)):
        '''Bucketed padded neighbor lists for batched ALS normal equations.

        Groups rows (users if axis='user', items if axis='item') by nnz into
        power-of-two buckets; each bucket yields
        ``(row_ids[R], nbr_idx[R, L], nbr_val[R, L], mask[R, L])``.
        Replaces the reference's serial CSR walk in ``als_implicit.pyx:264-302``
        with a layout that maps to batched MXU matmuls.
        '''
        key = ('padded', axis, buckets)
        if key in self._cache:
            return self._cache[key]
        if axis == 'user':
            ptr, nbr, val = self.csr()
            nrows = self.nbr_users
        else:
            ptr, nbr, val = self.csc()
            nrows = self.nbr_items
        counts = np.diff(ptr)
        out = []
        max_needed = int(counts.max()) if nrows and counts.size else 0
        blist = [b for b in buckets if b <= max_needed] or [buckets[0]]
        # complete the power-of-two ladder up to the largest row, so a few
        # huge rows don't inflate everything above the ladder into one
        # massively padded bucket
        while blist[-1] < max_needed:
            blist.append(blist[-1] * 2)
        prev = 0
        for L in blist:
            if L == blist[-1]:
                rows = np.nonzero((counts > prev))[0]
            else:
                rows = np.nonzero((counts > prev) & (counts <= L))[0]
            prev = L
            if rows.size == 0:
                continue
            idx, vals, mask = padded_segment_gather(ptr, rows, L, nbr, val)
            out.append((rows.astype(np.int32), idx, vals, mask))
        self._cache[key] = out
        return out
