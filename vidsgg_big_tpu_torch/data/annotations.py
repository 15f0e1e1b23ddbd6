"""Annotation dataset APIs (VidVRD-helper equivalents).

A copy of the JAX package's ``data/annotations.py``.

Capability-parity with the vendored helper repo's dataset classes
(reference VidVRD-helper/dataset/dataset.py:8-254, vidvrd.py, vidor.py):
annotation loading, id<->name indexes, object / action / relation instance
extraction, and the one-time challenge-GT JSON generation
(reference VidVRD-helper/prepare_gts_for_eval.py:10-49).
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict


class AnnotationDataset:
    """Base: maintains split indexes and category <-> id maps derived from
    the annotations themselves (sorted names, as the helper repo does)."""

    def __init__(self, anno_rpath: str, splits, video_rpath: str = ""):
        self.anno_rpath = anno_rpath
        self.video_rpath = video_rpath
        self._load_annotations(splits)

    # -- per-dataset hooks --
    def _get_anno_files(self, split):
        raise NotImplementedError

    def _get_action_predicates(self):
        raise NotImplementedError

    def _load_annotations(self, splits):
        so, pred = set(), set()
        self.split_index = defaultdict(list)
        self.annos = {}
        for split in splits:
            for path in self._get_anno_files(split):
                with open(path) as f:
                    anno = json.load(f)
                vid = anno["video_id"]
                self.annos[vid] = anno
                self.split_index[split].append(vid)
                for obj in anno["subject/objects"]:
                    so.add(obj["category"])
                for rel in anno["relation_instances"]:
                    pred.add(rel["predicate"])
        so, pred = sorted(so), sorted(pred)
        self.soid2so = dict(enumerate(so))
        self.so2soid = {n: i for i, n in enumerate(so)}
        self.pid2pred = dict(enumerate(pred))
        self.pred2pid = {n: i for i, n in enumerate(pred)}

    # -- index / vocab accessors (helper-repo API surface) --
    def get_object_num(self):
        return len(self.soid2so)

    def get_object_name(self, cid):
        return self.soid2so[cid]

    def get_object_id(self, name):
        return self.so2soid[name]

    def get_predicate_num(self):
        return len(self.pid2pred)

    def get_predicate_name(self, pid):
        return self.pid2pred[pid]

    def get_predicate_id(self, name):
        return self.pred2pid[name]

    def get_index(self, split):
        if split in self.split_index:
            return self.split_index[split]
        for s in self.split_index:
            if split in s:
                return self.split_index[s]
        raise KeyError(f'Unknown split "{split}"')

    def get_anno(self, vid):
        return self.annos[vid]

    def get_triplets(self, split):
        triplets = set()
        for vid in self.get_index(split):
            triplets.update(inst["triplet"] for inst in
                            self.get_relation_insts(vid, no_traj=True))
        return triplets

    # -- instance extraction --
    def get_object_insts(self, vid):
        return object_insts_from_anno(self.get_anno(vid))

    def get_action_insts(self, vid):
        anno = self.get_anno(vid)
        actions = self._get_action_predicates()
        insts = []
        for ins in anno["relation_instances"]:
            if ins["predicate"] not in actions:
                continue
            traj = []
            for frame in anno["trajectories"][ins["begin_fid"]:
                                              ins["end_fid"]]:
                for roi in frame:
                    if roi["tid"] == ins["subject_tid"]:
                        traj.append((roi["bbox"]["xmin"], roi["bbox"]["ymin"],
                                     roi["bbox"]["xmax"], roi["bbox"]["ymax"]))
            insts.append({"category": ins["predicate"],
                          "duration": (ins["begin_fid"], ins["end_fid"]),
                          "trajectory": traj})
        return insts

    def get_relation_insts(self, vid, no_traj: bool = False):
        """Challenge-format GT relation instances of one video."""
        return relation_insts_from_anno(self.get_anno(vid), no_traj=no_traj)


def object_insts_from_anno(anno: dict):
    """Per-tid trajectories of one raw annotation dict."""
    tid2cls = {o["tid"]: o["category"] for o in anno["subject/objects"]}
    traj = defaultdict(dict)
    for fid, frame in enumerate(anno["trajectories"]):
        for roi in frame:
            traj[roi["tid"]][str(fid)] = (
                roi["bbox"]["xmin"], roi["bbox"]["ymin"],
                roi["bbox"]["xmax"], roi["bbox"]["ymax"])
    return [{"tid": tid, "category": tid2cls[tid], "trajectory": t}
            for tid, t in traj.items()]


def relation_insts_from_anno(anno: dict, no_traj: bool = False):
    """Challenge-format relation instances of one raw annotation dict."""
    sub_objs = {o["tid"]: o["category"] for o in anno["subject/objects"]}
    if not no_traj:
        trajs = []
        for frame in anno["trajectories"]:
            trajs.append({b["tid"]: (b["bbox"]["xmin"], b["bbox"]["ymin"],
                                     b["bbox"]["xmax"], b["bbox"]["ymax"])
                          for b in frame})
    insts = []
    for ins in anno["relation_instances"]:
        inst = {
            "triplet": (sub_objs[ins["subject_tid"]], ins["predicate"],
                        sub_objs[ins["object_tid"]]),
            "subject_tid": ins["subject_tid"],
            "object_tid": ins["object_tid"],
            "duration": (ins["begin_fid"], ins["end_fid"]),
        }
        if not no_traj:
            inst["sub_traj"] = [b[ins["subject_tid"]] for b in
                                trajs[ins["begin_fid"]:ins["end_fid"]]]
            inst["obj_traj"] = [b[ins["object_tid"]] for b in
                                trajs[ins["begin_fid"]:ins["end_fid"]]]
        insts.append(inst)
    return insts


class VidVRD(AnnotationDataset):
    def _get_anno_files(self, split):
        files = glob.glob(os.path.join(self.anno_rpath, split, "*.json"))
        if not files:
            raise FileNotFoundError(
                f"no annotations under {self.anno_rpath}/{split}")
        return sorted(files)

    def _get_action_predicates(self):
        actions = ["bite", "chase", "creep", "drive", "fall", "faster",
                   "feed", "fight", "fly", "follow", "hold", "jump", "kick",
                   "lie", "move", "play", "pull", "push", "ride", "run",
                   "sit", "stand", "stop", "swim", "taller", "touch", "walk",
                   "watch"]
        return actions


class VidOR(AnnotationDataset):
    def _get_anno_files(self, split):
        files = glob.glob(os.path.join(self.anno_rpath, split, "*/*.json"))
        if not files:
            raise FileNotFoundError(
                f"no annotations under {self.anno_rpath}/{split}")
        return sorted(files)

    def _get_action_predicates(self):
        return [p for p in self.pred2pid
                if p not in ("above", "away", "behind", "beneath",
                             "in_front_of", "inside", "next_to", "towards")]


def prepare_gts_for_eval(dataset: AnnotationDataset, split: str,
                         save_path: str | None = None):
    """{vid: relation_insts} challenge GT JSON (reference
    prepare_gts_for_eval.py:10-49)."""
    gts = {vid: dataset.get_relation_insts(vid)
           for vid in dataset.get_index(split)}
    if save_path:
        with open(save_path, "w") as f:
            json.dump(gts, f)
    return gts
