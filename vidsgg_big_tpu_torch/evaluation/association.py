"""Greedy relational association for the segment-proposal baseline.

A copy of the JAX package's ``evaluation/association.py`` (host numpy and
Python: association is list bookkeeping, sequential per video).  It
rebuilds the video-level association stage of the vendored MM'17 baseline
(reference VidVRD-helper/baseline/association.py:16-171 and
baseline/trajectory.py:85-158): short-term relation predictions on 30-frame
segments are greedily linked across segments into video-level relation
instances whenever the triplet matches and both the subject and object
trajectories overlap (windowed cubic IoU >= 0.5) with a relation modified in
the previous segment.

Two reference quirks are kept because they define the baseline's
published numbers:
  * a relation that fails to merge in a non-first segment is created with the
    default confidence 1 instead of its prediction score (reference
    association.py:166 passes no ``confs``);
  * ``extend`` sets the relation's end frame from the *object* trajectory
    (reference association.py:93-98).
So is its order: stable score sorts, and the removal from
``last_modified`` inside the loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def segment_video(fstart: int, fend: int) -> List[Tuple[int, int]]:
    """30-frame segments with 15-frame overlap (reference baseline/__init__.py:35-41).

    Durations here are half-open [fstart, fend), as in the raw annotations.
    """
    return [(i, i + 30) for i in range(fstart, fend - 30 + 1, 15)]


def get_segment_signature(vid: str, fstart: int, fend: int) -> str:
    """Reference baseline/__init__.py:5-9."""
    return "{}-{:04d}-{:04d}".format(vid, fstart, fend)


def cubic_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """All-pairs volumetric IoU of frame-aligned boxes, +1 area convention.

    boxes: (n, t, 4) / (m, t, 4) in (left, top, right, bottom); returns
    (n, m).  Vectorized form of reference baseline/trajectory.py:85-141
    (which loops python-side over t).
    """
    b1 = np.asarray(boxes1, np.float64)
    b2 = np.asarray(boxes2, np.float64)
    lt = np.maximum(b1[:, None, :, :2], b2[None, :, :, :2])    # (n, m, t, 2)
    rb = np.minimum(b1[:, None, :, 2:], b2[None, :, :, 2:])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = (wh[..., 0] * wh[..., 1]).sum(-1)                  # (n, m)
    area1 = ((b1[..., 2] - b1[..., 0] + 1) *
             (b1[..., 3] - b1[..., 1] + 1)).sum(-1)            # (n,)
    area2 = ((b2[..., 2] - b2[..., 0] + 1) *
             (b2[..., 3] - b2[..., 1] + 1)).sum(-1)            # (m,)
    union = area1[:, None] + area2[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


@dataclasses.dataclass
class Trajectory:
    """Bounding-box trajectory over frames [pstart, pend).

    Plain-numpy equivalent of reference baseline/trajectory.py:12-82 (which
    stores a deque of dlib drectangles); rois is (pend - pstart, 4) ltrb.
    """
    pstart: int
    pend: int
    rois: np.ndarray
    score: float = 0.0
    category: int = -1
    gt_trackid: int = -1

    def __post_init__(self):
        self.rois = np.asarray(self.rois, np.float64).reshape(-1, 4)
        assert len(self.rois) == self.pend - self.pstart, \
            (self.pstart, self.pend, self.rois.shape)

    def length(self) -> int:
        return self.pend - self.pstart

    def copy(self) -> "Trajectory":
        return Trajectory(self.pstart, self.pend, self.rois.copy(),
                          self.score, self.category, self.gt_trackid)

    def serialize_rois(self) -> List[List[float]]:
        return [[float(v) for v in roi] for roi in self.rois]


def traj_iou_windowed(t1: Trajectory, t2: Trajectory) -> float:
    """Cubic IoU of two trajectories over their frame overlap window.

    Reference baseline/association.py:35-48 (``_traj_iou``): 0 when the
    windows don't overlap; otherwise both are cut to
    [later_start.pstart, earlier_start.pend) and compared frame-aligned.
    """
    if t1.pend <= t2.pstart or t2.pend <= t1.pstart:
        return 0.0
    a, b = (t1, t2) if t1.pstart <= t2.pstart else (t2, t1)
    cut_a = a.rois[b.pstart - a.pstart: a.pend - a.pstart]
    cut_b = b.rois[0: a.pend - b.pstart]
    return float(cubic_iou(cut_a[None], cut_b[None])[0, 0])


def merge_trajs(traj_1: Trajectory, traj_2: Trajectory) -> Trajectory:
    """Merge an overlapping continuation into ``traj_1`` (in place).

    Overlapping frames are averaged, the remainder appended (reference
    association.py:16-32).
    """
    assert traj_1.pend > traj_2.pstart and traj_1.pstart < traj_2.pend, \
        (traj_1.pstart, traj_1.pend, traj_2.pstart, traj_2.pend)
    overlap = max(traj_1.pend - traj_2.pstart, 0)
    if overlap:
        traj_1.rois[len(traj_1.rois) - overlap:] = (
            traj_1.rois[len(traj_1.rois) - overlap:] +
            traj_2.rois[:overlap]) / 2.0
    traj_1.rois = np.concatenate([traj_1.rois, traj_2.rois[overlap:]], 0)
    traj_1.pend = traj_1.pstart + len(traj_1.rois)
    return traj_1


class VideoRelation:
    """Video-level relation instance being grown across segments.

    Reference association.py:51-114.
    """

    def __init__(self, vid: str, s_cid: int, pid: int, o_cid: int,
                 straj: Trajectory, otraj: Trajectory, confs: float = 1.0):
        self.vid = vid
        self.s_cid = s_cid
        self.pid = pid
        self.o_cid = o_cid
        self.straj = straj
        self.otraj = otraj
        self.confs_list = [confs]
        self.fstart = straj.pstart
        self.fend = straj.pend

    def triplet(self) -> Tuple[int, int, int]:
        return (self.s_cid, self.pid, self.o_cid)

    def mean_confs(self) -> float:
        return float(np.mean(self.confs_list))

    def both_overlap(self, straj: Trajectory, otraj: Trajectory,
                     iou_thr: float = 0.5) -> bool:
        return (traj_iou_windowed(self.straj, straj) >= iou_thr and
                traj_iou_windowed(self.otraj, otraj) >= iou_thr)

    def extend(self, straj: Trajectory, otraj: Trajectory, confs: float):
        self.straj = merge_trajs(self.straj, straj)
        self.otraj = merge_trajs(self.otraj, otraj)
        self.confs_list.append(confs)
        self.fstart = self.straj.pstart
        self.fend = self.otraj.pend    # reference quirk: end from the object

    def serialize(self, object_names: Sequence[str],
                  predicate_names: Sequence[str]) -> dict:
        return {
            "triplet": [object_names[self.s_cid], predicate_names[self.pid],
                        object_names[self.o_cid]],
            "score": self.mean_confs(),
            "duration": [int(self.fstart), int(self.fend)],
            "sub_traj": self.straj.serialize_rois(),
            "obj_traj": self.otraj.serialize_rois(),
        }


def greedy_relational_association(
        short_term_relations: List[Tuple[Tuple[str, int, int], tuple]],
        trajs_lookup: Dict[Tuple[str, int, int], List[Trajectory]],
        object_names: Sequence[str], predicate_names: Sequence[str],
        max_traj_num_in_clip: int = 100,
        truncate_per_segment: Optional[int] = None) -> List[dict]:
    """Link per-segment predictions into video-level relations.

    Args:
      short_term_relations: list of ``((vid, fstart, fend), predictions)``
        where predictions is a list of ``(score, (s_cid, pid, o_cid),
        (s_traj_idx, o_traj_idx))`` tuples for one segment.
      trajs_lookup: segment key -> that segment's trajectory proposals.
      max_traj_num_in_clip: per-segment prediction cap after score sort
        (reference association.py:126-127; despite the name it caps
        predictions, not trajectories).

    Returns challenge-format dicts (reference association.py:100-114, 171).
    """
    del truncate_per_segment
    short_term_relations = sorted(short_term_relations,
                                  key=lambda x: int(x[0][1]))
    video_relation_list: List[VideoRelation] = []
    last_modified: List[VideoRelation] = []
    for i, (index, pred_list) in enumerate(short_term_relations):
        vid, fstart, fend = index
        sorted_preds = sorted(pred_list, key=lambda x: x[0], reverse=True)
        sorted_preds = sorted_preds[:max_traj_num_in_clip]
        trajs = trajs_lookup[index]
        cur_modified: List[VideoRelation] = []
        for conf_score, (s_cid, pid, o_cid), (s_idx, o_idx) in sorted_preds:
            straj = trajs[s_idx].copy()
            otraj = trajs[o_idx].copy()
            straj.pstart, straj.pend = fstart, fend
            otraj.pstart, otraj.pend = fstart, fend
            if i == 0:
                r = VideoRelation(vid, s_cid, pid, o_cid, straj, otraj,
                                  confs=conf_score)
                video_relation_list.append(r)
                cur_modified.append(r)
                continue
            last_modified.sort(key=lambda r: r.mean_confs(), reverse=True)
            merged = False
            for r in last_modified:
                if ((s_cid, pid, o_cid) == r.triplet()
                        and straj.pstart < r.fend and otraj.pstart < r.fend
                        and r.both_overlap(straj, otraj)):
                    r.extend(straj, otraj, conf_score)
                    last_modified.remove(r)
                    cur_modified.append(r)
                    merged = True
                    break
            if not merged:
                # reference quirk: no confs argument here -> default 1.0
                r = VideoRelation(vid, s_cid, pid, o_cid, straj, otraj)
                video_relation_list.append(r)
                cur_modified.append(r)
        last_modified = cur_modified
    return [r.serialize(object_names, predicate_names)
            for r in video_relation_list]
