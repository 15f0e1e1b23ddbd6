"""Model output -> challenge-JSON format conversion.

Numpy equivalent of the reference ``EvalFmtCvtor`` (reference
utils/evaluate.py:12-341): cuts subject/object trajectories to each triplet's
subject∩object window and emits the challenge dicts
``{triplet, duration [s, e), score, sub_traj, obj_traj}``.

A copy of the JAX package's ``evaluation/convert.py`` that reads the port's
records and its per-video :class:`~..models.triplets.Triplets` (numpy
leaves, from ``Triplets.numpy().video(i)``).
"""
from __future__ import annotations

import numpy as np

from ..data.types import VideoProposalRecord, VideoGTRecord
from ..utils.categories import get_vocab


def traj_cutoff(traj, ori_dura, dura, debug_info=None):
    """Slice a trajectory (half-open durations), with contract asserts
    matching reference utils/utils_func.py:523-536."""
    assert len(traj) == ori_dura[1] - ori_dura[0], \
        f"len(traj)={len(traj)} != {ori_dura[1] - ori_dura[0]}, {debug_info}"
    s_o, e_o = ori_dura
    ss, ee = dura
    assert s_o <= ss and ee <= e_o, f"ori={ori_dura}, dura={dura}, {debug_info}"
    return traj[ss - s_o: len(traj) - (e_o - ee)]


class EvalFmtCvtor:
    def __init__(self, dataset_type: str):
        self.dataset_type = dataset_type.lower()
        self.enti_id2name, self.pred_id2name = get_vocab(self.dataset_type)

    def _reset_video_name(self, video_name: str) -> str:
        if self.dataset_type == "vidor":
            parts = video_name.split("_")   # "0001_3598080384" -> id
            assert len(parts) == 2
            return parts[1]
        return video_name

    def to_eval_format_pr(self, proposal: VideoProposalRecord, triplets,
                          use_pku: bool = False):
        """Convert one video's predicted triplets.

        triplets: either a host tuple (quintuples (M,5), scores (M,) or
        (M,3)-reduced, dura_inters (M,2) closed) with only valid rows, or
        one video's ``Triplets`` (the valid mask is applied here).
        """
        enti_id2name = (get_vocab("vidvrd", use_pku=True)[0] if use_pku
                        else self.enti_id2name)
        video_name = self._reset_video_name(proposal.video_name)
        if triplets is None:
            return {video_name: []}
        if hasattr(triplets, "valid"):
            valid = np.asarray(triplets.valid)
            quintuples = np.asarray(triplets.quintuples)[valid]
            scores = np.asarray(triplets.scores)[valid]
            dura_inters = np.asarray(triplets.dura_inters)[valid]
        else:
            quintuples, scores, dura_inters = triplets
            quintuples = np.asarray(quintuples)
            scores = np.asarray(scores)
            dura_inters = np.asarray(dura_inters)
        if scores.ndim == 2:
            # (M, 3) [pred, subj, obj] -> mean, as the reference eval tools do
            # before conversion (reference tools/eval_vidvrd.py:135)
            scores = scores.mean(axis=-1)

        results = []
        durations = np.asarray(proposal.durations)
        for p_id in range(quintuples.shape[0]):
            pred_catid, s_cat, o_cat, s_tid, o_tid = (
                int(x) for x in quintuples[p_id])
            if pred_catid == 0:
                continue
            dura_ = (int(dura_inters[p_id][0]), int(dura_inters[p_id][1]) + 1)
            s_dura = (int(durations[s_tid][0]), int(durations[s_tid][1]) + 1)
            o_dura = (int(durations[o_tid][0]), int(durations[o_tid][1]) + 1)
            sub_traj = traj_cutoff(proposal.boxes[s_tid], s_dura, dura_,
                                   video_name)
            obj_traj = traj_cutoff(proposal.boxes[o_tid], o_dura, dura_,
                                   video_name)
            assert len(sub_traj) == len(obj_traj) == dura_[1] - dura_[0]
            results.append({
                "triplet": [enti_id2name[s_cat], self.pred_id2name[pred_catid],
                            enti_id2name[o_cat]],
                "duration": dura_,
                "score": float(scores[p_id]),
                "sub_traj": np.asarray(sub_traj)[:, :4].tolist(),
                "obj_traj": np.asarray(obj_traj)[:, :4].tolist(),
            })
        return {video_name: results}

    def to_eval_format_gt(self, gt: VideoGTRecord):
        """GT graph -> challenge format (the "our_gt" eval path, reference
        utils/evaluate.py:234-286)."""
        video_name = self._reset_video_name(gt.video_name)
        if gt.num_trajs == 0 or gt.num_preds == 0:
            return {video_name: []}
        adj = np.asarray(gt.adj)
        pred2so = adj.argmax(-1).transpose(1, 0)         # (P, 2)
        traj_durs = np.asarray(gt.traj_durations)
        results = []
        for g_id in range(gt.num_preds):
            s_id, o_id = int(pred2so[g_id, 0]), int(pred2so[g_id, 1])
            pred_catid = int(gt.pred_cat_ids[g_id])
            if pred_catid == 0:
                continue
            s_cat = int(gt.traj_cat_ids[s_id])
            o_cat = int(gt.traj_cat_ids[o_id])
            s_dura = (int(traj_durs[s_id][0]), int(traj_durs[s_id][1]) + 1)
            o_dura = (int(traj_durs[o_id][0]), int(traj_durs[o_id][1]) + 1)
            inter = (max(s_dura[0], o_dura[0]), min(s_dura[1], o_dura[1]))
            pd = gt.pred_durations[g_id]
            dura_spo = (int(pd[0]), int(pd[1]) + 1)
            # GT predicate durations always lie inside the subj∩obj overlap
            assert inter[0] <= dura_spo[0] and dura_spo[1] <= inter[1]
            sub_traj = traj_cutoff(gt.traj_boxes[s_id], s_dura, dura_spo)
            obj_traj = traj_cutoff(gt.traj_boxes[o_id], o_dura, dura_spo)
            results.append({
                "triplet": [self.enti_id2name[s_cat],
                            self.pred_id2name[pred_catid],
                            self.enti_id2name[o_cat]],
                "duration": dura_spo,
                "sub_traj": np.asarray(sub_traj)[:, :4].tolist(),
                "obj_traj": np.asarray(obj_traj)[:, :4].tolist(),
            })
        return {video_name: results}
