"""Pre-training data: trajectory batches + per-task labels.

The port's own numpy copy of `vln_imagine_tpu/pretrain/data.py`: the same
RNG calls in the same order, so every batch and every task draw equals the
JAX package's for the same seed.  Host-side rebuild of MultiStepNavData + the six task datasets/collates
(VLN-HAMT/pretrain_src/data/r2r_data.py:95-346, r2r_tasks.py:12-597) over the
compiled world tables.  Real annotations plug in through the same batch dict;
the synthetic generator draws trajectories from the episode gt paths.

Batch layout (HAMT obs convention: [K candidate slots | STOP | V views]):
  txt_ids/txt_masks, hist_* ([B, T, ...] step-major), hist_masks [B, T+1]
  (global token first), ob_* at the sampled step, plus task labels.
"""

from __future__ import annotations

import math

import numpy as np

from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.ops.angles import all_point_angle_feature

MASK_TOKEN = 3  # synthetic [MASK] id; real data uses the tokenizer's id


class TrajectoryBatcher:
    """Builds task batches from (world, episodes) with numpy only."""

    def __init__(self, world: WorldTables, ep: EpisodeBatch,
                 max_hist_len: int, angle_feat_size: int = 4,
                 image_prob_size: int = 64, vocab_size: int = 1000,
                 mask_token: int = MASK_TOKEN, seed: int = 0,
                 mlm_prob: float = 0.15, mrc_prob: float = 0.15):
        self.w = {k: np.asarray(v) for k, v in
                  dict(adj=world.adj, adj_valid=world.adj_valid,
                       pointid=world.cand_pointid, head=world.cand_heading,
                       elev=world.cand_elevation, feat=world.feat).items()}
        self.views = world.views
        self.K = world.max_candidates
        self.Df = self.w["feat"].shape[-1]
        self.A = angle_feat_size
        self.ep = ep
        self.T = max_hist_len
        self.P = image_prob_size
        self.vocab = vocab_size
        self.mask_token = mask_token
        self.mlm_prob = mlm_prob
        self.mrc_prob = mrc_prob
        self.rng = np.random.default_rng(seed)
        # separate stream for batch-index draws so a pipelined subclass that
        # draws indices one batch ahead (PrefetchTrajectoryBatcher) yields
        # byte-identical batches to the synchronous order
        self.idx_rng = np.random.default_rng(seed + 1)
        self.angle_table = all_point_angle_feature(angle_feat_size,
                                                   world.views)
        # per-episode viewpoint sequence and action views
        self.paths = [np.asarray(ep.gt_path[b, :ep.gt_len[b]])
                      for b in range(ep.batch)]
        self.scans = np.asarray(ep.scan)

    # ------------------------------------------------------------- pieces
    def _action_slot(self, scan, node, target):
        adj = self.w["adj"][scan, node]
        valid = self.w["adj_valid"][scan, node]
        hits = np.flatnonzero((adj == target) & valid)
        assert len(hits), "gt step is not a neighbour"
        return int(hits[0])

    def _feat(self, scan, node) -> np.ndarray:
        """[V, Df] panorama features of one node; subclasses may serve this
        from an mmap feature bank instead of device-shadow arrays."""
        return self.w["feat"][scan, node]

    def _view_heading(self, v):
        per = self.views // 3
        return (v % per) * (2 * math.pi / per)

    def _view_elev(self, v):
        per = self.views // 3
        return (v // per - 1) * math.radians(30.0)

    def _trajectory(self, b: int, t: int):
        """History features for steps 0..t-1 and obs arrays at step t."""
        scan = self.scans[b]
        path = self.paths[b]
        T, V, Df, A, K = self.T, self.views, self.Df, self.A, self.K
        hist_img = np.zeros((T, Df), np.float32)
        hist_ang = np.zeros((T, A), np.float32)
        hist_pano_img = np.zeros((T, V, Df), np.float32)
        hist_pano_ang = np.zeros((T, V, A), np.float32)
        # (node, view) provenance per history step / obs slot, so the
        # raw-image batcher (E2EImageBatcher) can fetch pixels for the same
        # trajectory without duplicating this logic
        hist_node = np.zeros((T,), np.int64)
        hist_view = np.zeros((T,), np.int64)
        cur_view = self.views // 3  # heading 0, horizon row
        for i in range(t):
            node, nxt = path[i], path[i + 1]
            slot = self._action_slot(scan, node, nxt)
            pid = self.w["pointid"][scan, node, slot]
            feat = self._feat(scan, node)
            hist_img[i] = feat[pid]
            hist_node[i] = node
            hist_view[i] = pid
            dh = self.w["head"][scan, node, slot] - self._view_heading(cur_view)
            de = self.w["elev"][scan, node, slot]
            hist_ang[i] = np.tile(
                [np.sin(dh), np.cos(dh), np.sin(de), np.cos(de)], A // 4)
            hist_pano_img[i] = feat
            hist_pano_ang[i] = self.angle_table[cur_view]
            cur_view = pid

        # observation at step t (layout [K cands | stop | V views])
        node = path[t]
        feat = self._feat(scan, node)
        adj_valid = self.w["adj_valid"][scan, node]
        pid = self.w["pointid"][scan, node]
        T_obs = K + 1 + V
        ob_img = np.zeros((T_obs, Df), np.float32)
        ob_ang = np.zeros((T_obs, A), np.float32)
        nav = np.zeros((T_obs,), np.int64)
        valid = np.zeros((T_obs,), bool)
        base_h = self._view_heading(cur_view)
        for k in range(K):
            if not adj_valid[k]:
                continue
            ob_img[k] = feat[pid[k]]
            dh = self.w["head"][scan, node, k] - base_h
            de = self.w["elev"][scan, node, k]
            ob_ang[k] = np.tile([np.sin(dh), np.cos(dh), np.sin(de),
                                 np.cos(de)], A // 4)
            nav[k] = 1
            valid[k] = True
        nav[K] = 2
        valid[K] = True
        used = set(int(p) for p, v in zip(pid, adj_valid) if v)
        ob_img[K + 1:] = feat
        ob_ang[K + 1:] = self.angle_table[cur_view]
        valid[K + 1:] = [v not in used for v in range(V)]

        if t < len(path) - 1:
            act = self._action_slot(scan, node, path[t + 1])
        else:
            act = K  # stop slot
        progress = t / max(len(path) - 1, 1)
        # action angles relative to current view (SAR target)
        if act < K:
            act_h = self.w["head"][scan, node, act] - base_h
            act_e = self.w["elev"][scan, node, act]
        else:
            act_h = act_e = 0.0
        return dict(hist_img=hist_img, hist_ang=hist_ang,
                    hist_pano_img=hist_pano_img, hist_pano_ang=hist_pano_ang,
                    hist_len=t, ob_img=ob_img, ob_ang=ob_ang, nav=nav,
                    valid=valid, act=act, progress=progress,
                    act_angles=np.array([act_h, act_e], np.float32),
                    cur_view=cur_view, hist_node=hist_node,
                    hist_view=hist_view, ob_node=int(node),
                    ob_pids=pid.copy())

    # -------------------------------------------------------------- batch
    def base_batch(self, idxs: np.ndarray, end_step: bool = False):
        B = len(idxs)
        steps = []
        for b in idxs:
            L = len(self.paths[b])
            steps.append(L - 1 if end_step else int(self.rng.integers(0, L)))
        items = [self._trajectory(b, t) for b, t in zip(idxs, steps)]
        self._last_items = items  # subclasses stack extra per-item tensors
        ep = self.ep

        def stack(key):
            return np.stack([it[key] for it in items])

        hist_masks = np.zeros((B, self.T + 1), bool)
        for i, it in enumerate(items):
            hist_masks[i, :it["hist_len"] + 1] = True
        return {
            "txt_ids": np.asarray(ep.txt_ids)[idxs],
            "txt_masks": np.asarray(ep.txt_mask)[idxs],
            "hist_img_fts": stack("hist_img"),
            "hist_ang_fts": stack("hist_ang"),
            "hist_pano_img_fts": stack("hist_pano_img"),
            "hist_pano_ang_fts": stack("hist_pano_ang"),
            "hist_masks": hist_masks,
            "ob_img_fts": stack("ob_img"),
            "ob_ang_fts": stack("ob_ang"),
            "ob_nav_types": stack("nav"),
            "ob_masks": stack("valid"),
            "ob_action_viewindex": np.asarray([it["act"] for it in items]),
            "ob_action_angles": stack("act_angles"),
            "ob_progress": np.asarray([it["progress"] for it in items],
                                      np.float32),
            "cur_view": np.asarray([it["cur_view"] for it in items]),
        }

    def mlm_batch(self, idxs, mlm_prob=None):
        """BERT-style 80/10/10 masking (r2r_tasks.py:12-53)."""
        mlm_prob = self.mlm_prob if mlm_prob is None else mlm_prob
        batch = self.base_batch(idxs)
        ids = batch["txt_ids"].copy()
        labels = np.full_like(ids, -1)
        mask = (self.rng.random(ids.shape) < mlm_prob) & batch["txt_masks"]
        mask[:, 0] = False  # keep [CLS]
        # guarantee at least one prediction per item
        for i in range(len(ids)):
            if not mask[i].any():
                cands = np.flatnonzero(batch["txt_masks"][i])[1:]
                mask[i, self.rng.choice(cands)] = True
        r = self.rng.random(ids.shape)
        labels[mask] = ids[mask]
        ids[mask & (r < 0.8)] = self.mask_token
        rand = mask & (r >= 0.8) & (r < 0.9)
        ids[rand] = self.rng.integers(4, self.vocab, int(rand.sum()))
        batch["txt_ids"] = ids
        batch["txt_labels"] = labels
        return batch

    def mrc_batch(self, idxs, mrc_prob=None):
        """Mask whole history steps; soft labels are ViT class probs for the
        step view (synthetic: random simplex vectors) (r2r_tasks.py:155-228)."""
        mrc_prob = self.mrc_prob if mrc_prob is None else mrc_prob
        batch = self.base_batch(idxs)
        B = len(idxs)
        lens = batch["hist_masks"][:, 1:].sum(1)
        mrc_mask = np.zeros((B, self.T), bool)
        for i in range(B):
            if lens[i] == 0:
                continue
            m = self.rng.random(lens[i]) < mrc_prob
            if not m.any():
                m[self.rng.integers(0, lens[i])] = True
            mrc_mask[i, :lens[i]] = m
        probs = self.rng.dirichlet(np.ones(self.P), size=(B, self.T)).astype(
            np.float32)
        batch["hist_mrc_masks"] = mrc_mask
        batch["hist_img_probs"] = probs
        # zero out masked step features (the reference replaces them)
        batch["hist_img_fts"] = np.where(mrc_mask[:, :, None], 0.0,
                                         batch["hist_img_fts"])
        return batch

    def sprel_batch(self, idxs):
        """Anchor view + per-view relative (heading, elevation) targets
        (r2r_tasks.py SpRel)."""
        batch = self.base_batch(idxs)
        B = len(idxs)
        V = self.views
        per = V // 3
        anchors = self.rng.integers(0, V, B)
        targets = np.zeros((B, V, 2), np.float32)
        for i, a in enumerate(anchors):
            for v in range(V):
                dh = ((v % per) - (a % per)) * (2 * math.pi / per)
                dh = (dh + math.pi) % (2 * math.pi) - math.pi
                de = ((v // per) - (a // per)) * math.radians(30.0)
                targets[i, v] = (dh, de)
        # anchor indexes into the pano region of the obs layout
        batch["sp_anchor_idxs"] = self.K + 1 + anchors
        batch["sp_targets"] = targets
        return batch

    def itm_batch(self, idxs, num_neg=4):
        batch = self.base_batch(idxs, end_step=True)
        B = len(idxs)
        K1 = num_neg // 2 if B > 1 else 0
        K2 = num_neg - K1
        neg_idxs = np.zeros((B, K1), np.int64)
        for i in range(B):
            others = [j for j in range(B) if j != i]
            for k in range(K1):
                neg_idxs[i, k] = self.rng.choice(others)
        lens = batch["hist_masks"][:, 1:].sum(1)
        shuffled = np.zeros((K2, B, self.T), np.int64)
        for k in range(K2):
            for i in range(B):
                perm = self.rng.permutation(lens[i])
                shuffled[k, i, :lens[i]] = perm
                shuffled[k, i, lens[i]:] = np.arange(lens[i], self.T)
        batch["neg_idxs"] = neg_idxs
        batch["shuffled_pos_ids"] = shuffled
        return batch

    def task_batch(self, task: str, batch_size: int, idxs=None):
        if idxs is None:
            idxs = draw_batch_indices(self.idx_rng, self.ep.batch,
                                      batch_size)
        if task == "mlm":
            return self.mlm_batch(idxs)
        if task == "mrc":
            return self.mrc_batch(idxs)
        if task == "sprel":
            return self.sprel_batch(idxs)
        if task == "itm":
            return self.itm_batch(idxs)
        if task in ("sap", "sar"):
            return self.base_batch(idxs)
        raise ValueError(task)


class E2EImageBatcher(TrajectoryBatcher):
    """Raw-image variants of the six task batches: the same trajectories,
    labels and layouts as TrajectoryBatcher, with pixel tensors in place of
    precomputed features (data/image_tasks.py:16-508).

    `images` is anything indexable as images[scan, node, view] ->
    [h, w, 3] and images[scan, node] -> [V, h, w, 3] (a RawPanoramaBank
    mmap or an in-memory [S, N, V, h, w, 3] array)."""

    IMAGE_KEYS = {"hist_img_fts": "hist_images",
                  "hist_pano_img_fts": "hist_pano_images",
                  "ob_img_fts": "ob_images"}

    def __init__(self, world: WorldTables, ep: EpisodeBatch, images,
                 **kwargs):
        super().__init__(world, ep, **kwargs)
        self.images = images
        self.hw = np.asarray(images[0, 0, 0]).shape[0]

    def _trajectory(self, b: int, t: int):
        it = super()._trajectory(b, t)
        scan = int(self.scans[b])
        T, V, K = self.T, self.views, self.K
        hw = self.hw
        hist_images = np.zeros((T, hw, hw, 3), np.float32)
        hist_pano_images = np.zeros((T, V, hw, hw, 3), np.float32)
        for i in range(it["hist_len"]):
            node = int(it["hist_node"][i])
            hist_images[i] = self.images[scan, node, int(it["hist_view"][i])]
            hist_pano_images[i] = self.images[scan, node]
        # observation layout [K cands | STOP (zeros) | V views]
        node = it["ob_node"]
        ob_images = np.zeros((K + 1 + V, hw, hw, 3), np.float32)
        pano = self.images[scan, node]
        for k in range(K):
            if it["valid"][k]:
                ob_images[k] = pano[int(it["ob_pids"][k])]
        ob_images[K + 1:] = pano
        it["hist_images"] = hist_images
        it["hist_pano_images"] = hist_pano_images
        it["ob_images"] = ob_images
        return it

    def base_batch(self, idxs: np.ndarray, end_step: bool = False):
        batch = super().base_batch(idxs, end_step=end_step)
        items = self._last_items
        for key in ("hist_images", "hist_pano_images", "ob_images"):
            batch[key] = np.stack([it[key] for it in items])
        return batch

    def task_batch(self, task: str, batch_size: int):
        batch = super().task_batch(task, batch_size)
        # feature keys are dropped: the E2E model embeds raw pixels with its
        # in-loop ViT (mrc's feature zero-masking happens post-backbone in
        # HamtE2EPretrainModel.forward_mrc, image_vilmodel.py:83-85)
        for fk in self.IMAGE_KEYS:
            batch.pop(fk, None)
        return batch


def draw_batch_indices(rng, n: int, batch_size: int) -> np.ndarray:
    """Batch indexes drawn ONE SCALAR AT A TIME: the idx stream is a flat
    sequence independent of batch grouping, so a pipelined consumer that
    pre-draws the next batch (and pushes indexes back on a batch-size
    change) consumes the exact same stream as the synchronous batcher for
    ANY sequence of batch sizes — e.g. init_state()'s size-2 probes
    followed by full-size training batches."""
    return np.asarray([int(rng.integers(0, n)) for _ in range(batch_size)],
                      np.int64)


class BankPrefetchMixin:
    """Prefetch engine shared by the HAMT and DUET pre-training batchers:
    panorama features are served from a native mmap FeatureBank through the
    C++ BankPrefetcher — while the device executes the step for batch t, the
    worker thread gathers the pano rows for batch t+1 (the reference
    PrefetchLoader overlap, pretrain_src/data/loader.py:90-124, which covers
    BOTH stacks there, moved host-side).

    Bank layout: row (scan * N + node) = that node's [V * Df] panorama
    features.  Batch indices come from `idx_rng` (a stream separate from the
    label RNG), so the one-batch-ahead draw yields byte-identical batches to
    the synchronous batcher with the same seed."""

    def _bank_init(self, world: WorldTables, bank, max_batch_rows: int):
        from vln_imagine_tpu_torch.native import BankPrefetcher

        self.N = np.asarray(world.node_xyz).shape[1]
        self.bank = bank
        assert bank.row_floats == self.views * self.Df, (
            f"bank rows must be [V*Df]={self.views * self.Df} floats, "
            f"got {bank.row_floats}")
        self.pf = BankPrefetcher(bank, max_batch_rows)
        self.w["feat"] = None  # all feature reads go through the bank
        self._pending = None   # (idxs, row_ids) of the submitted gather
        self._row_cache: dict[int, np.ndarray] = {}
        self._idx_buf: list[int] = []  # pre-drawn idx stream (see _submit)

    def _feat(self, scan, node) -> np.ndarray:
        rid = int(scan) * self.N + int(node)
        return self._row_cache[rid].reshape(self.views, self.Df)

    def _next_idxs(self, k: int) -> np.ndarray:
        while len(self._idx_buf) < k:
            self._idx_buf.append(int(self.idx_rng.integers(0,
                                                           self.ep.batch)))
        out = np.asarray(self._idx_buf[:k], np.int64)
        del self._idx_buf[:k]
        return out

    def _submit(self, batch_size: int):
        idxs = self._next_idxs(batch_size)
        # the full path covers every node any step draw can touch, so the
        # gather is valid for whichever task/steps get sampled next
        rows = sorted({int(self.scans[b]) * self.N + int(n)
                       for b in idxs for n in self.paths[b]})
        self.pf.submit(np.asarray(rows, np.int64))
        return idxs, rows

    def task_batch(self, task: str, batch_size: int, idxs=None):
        assert idxs is None, "prefetching batcher draws its own indices"
        if self._pending is None or len(self._pending[0]) != batch_size:
            if self._pending is not None:
                self.pf.wait()  # drain a mismatched in-flight job
                # push the pre-drawn indexes back so the stream position
                # stays identical to the synchronous batcher's across
                # batch-size changes (init_state probes -> training size)
                self._idx_buf[:0] = [int(i) for i in self._pending[0]]
            self._pending = self._submit(batch_size)
        idxs, rows = self._pending
        gathered = self.pf.wait()
        self._row_cache = {rid: gathered[i] for i, rid in enumerate(rows)}
        # submit the NEXT batch before assembling this one: the C++ worker
        # gathers (GIL released) while numpy assembly + the device step run
        self._pending = self._submit(batch_size)
        return super().task_batch(task, batch_size, idxs=idxs)


class PrefetchTrajectoryBatcher(BankPrefetchMixin, TrajectoryBatcher):
    """HAMT 6-task batcher over the async feature bank (see mixin)."""

    def __init__(self, world: WorldTables, ep: EpisodeBatch, bank,
                 max_batch_rows: int = 1024, **kwargs):
        super().__init__(world, ep, **kwargs)
        self._bank_init(world, bank, max_batch_rows)


class MetaSampler:
    """Weighted multinomial task mixing (pretrain_src/data/loader.py:18-88).
    The reference broadcasts the drawn task id to all ranks; here the draw is
    a shared-seed PRNG so every host samples identically."""

    def __init__(self, tasks, mix_ratio, seed=0):
        self.tasks = list(tasks)
        p = np.asarray(mix_ratio, np.float64)
        self.p = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def draw(self) -> str:
        return self.tasks[self.rng.choice(len(self.tasks), p=self.p)]
