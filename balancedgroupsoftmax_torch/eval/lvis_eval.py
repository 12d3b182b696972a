"""The federated LVIS evaluator of box ("bbox") and mask ("segm") results, in
numpy.

A copy of JAX `eval/lvis_eval.py` (`box_iou_xywh` :43, `LvisEvaluator`
:76-406, its mask IoU `_default_mask_iou` :184 with JAX `native.py:185-190`'s
numpy branch), which follows the reference's lvis-api
(lvis/eval.py LVISEval, lvis/results.py LVISResults):
- at most `max_dets` (300) detections an image, by score, at load time;
- federated filtering: an image's detections of a category neither in its
  ground truth nor in its `neg_category_ids` are dropped before matching;
- unmatched detections of a category in the image's
  `not_exhaustive_category_ids` are ignored, not false positives;
- COCO-style greedy matching per (image, category, IoU threshold), ignored
  ground truth last; areas all / < 32^2 / 32^2-96^2 / > 96^2; 101-point
  interpolated precision; IoU thresholds .5:.05:.95;
- frequency groups r/c/f from the categories' `frequency` for APr/APc/APf;
- box IoU on xywh boxes with no +1 (pycocotools' bbIou); mask IoU on the
  bitmaps of the detections' RLEs and the ground truth's polygons or RLEs
  (lvis-api `_to_mask` and pycocotools' mask.iou, no crowd);
- a record's area is its box's w x h in segm mode too (LVISResults'
  precedence for records that carry a "bbox", results.py:42-62).

Detections are the records {image_id, category_id, bbox [x, y, w, h], score}
that `eval.results` writes, with a "segmentation" RLE for segm. Records
without a box, and Mask-Scoring R-CNN's "segm_score", are not ported
(ROADMAP A8).
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List

import numpy as np

from ..utils.rle import decode_rle, segmentation_to_mask

IOU_THRS = np.linspace(0.5, 0.95, 10, endpoint=True)
REC_THRS = np.linspace(0.0, 1.0, 101, endpoint=True)
AREA_RNG = [
    [0.0, 1e10],
    [0.0, 32.0**2],
    [32.0**2, 96.0**2],
    [96.0**2, 1e10],
]
AREA_LBL = ["all", "small", "medium", "large"]


def box_iou_xywh(dt, gt) -> np.ndarray:
    """(D, G) IoU of xywh boxes, pycocotools bbIou semantics (no +1)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dt = np.asarray(dt, np.float64)
    gt = np.asarray(gt, np.float64)
    iw = np.clip(
        np.minimum((dt[:, 0] + dt[:, 2])[:, None], (gt[:, 0] + gt[:, 2])[None])
        - np.maximum(dt[:, 0][:, None], gt[:, 0][None]),
        0, None,
    )
    ih = np.clip(
        np.minimum((dt[:, 1] + dt[:, 3])[:, None], (gt[:, 1] + gt[:, 3])[None])
        - np.maximum(dt[:, 1][:, None], gt[:, 1][None]),
        0, None,
    )
    inter = iw * ih
    union = (dt[:, 2] * dt[:, 3])[:, None] + (gt[:, 2] * gt[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-12)


def mask_iou_bitmaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(A, B) IoU of flattened binary masks (A, P) and (B, P), no crowd. The
    intersections are a product of 0/1 matrices whose every partial sum is a
    whole number of at most P, exact in f32 below 2^24 pixels."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    dtype = np.float32 if a.shape[1] < 2**24 else np.float64
    a, b = np.asarray(a, dtype), np.asarray(b, dtype)
    inter = (a @ b.T).astype(np.float64)
    union = a.sum(-1, dtype=np.float64)[:, None] + b.sum(-1, dtype=np.float64)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


class LvisEvaluator:
    def __init__(
        self,
        gt_data: dict,  # the parsed LVIS annotation JSON
        detections: List[dict],  # result records
        iou_type: str = "bbox",
        max_dets: int = 300,
        federated: bool = True,
    ):
        """federated=False scores every category on every image (the COCO
        protocol, for files without `neg_category_ids`)."""
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type={iou_type!r}: bbox or segm")
        self.iou_type = iou_type
        self.max_dets = max_dets
        self.federated = federated
        self.results = OrderedDict()

        self.cat_ids = sorted(c["id"] for c in gt_data["categories"])
        self.cats = {c["id"]: c for c in gt_data["categories"]}
        self.imgs = {i["id"]: i for i in gt_data["images"]}

        # LVISResults: the max_dets best of each image, by score
        by_img: Dict[int, List[dict]] = defaultdict(list)
        for d in detections:
            by_img[d["image_id"]].append(d)
        self.dts_by_img_cat: Dict[tuple, List[dict]] = defaultdict(list)
        next_id = 1
        for img_id, dts in by_img.items():
            for d in sorted(dts, key=lambda d: -d["score"])[: self.max_dets]:
                d = dict(d, id=next_id)
                next_id += 1
                d.setdefault("area", float(d["bbox"][2] * d["bbox"][3]))
                self.dts_by_img_cat[(img_id, d["category_id"])].append(d)

        self.gts_by_img_cat: Dict[tuple, List[dict]] = defaultdict(list)
        img_pl: Dict[int, set] = defaultdict(set)
        for ann in gt_data["annotations"]:
            ann = dict(ann)
            ann.setdefault("ignore", 0)
            self.gts_by_img_cat[(ann["image_id"], ann["category_id"])].append(ann)
            img_pl[ann["image_id"]].add(ann["category_id"])
        self.img_nl = {i["id"]: set(i.get("neg_category_ids", [])) for i in gt_data["images"]}
        self.img_nel = {i["id"]: set(i.get("not_exhaustive_category_ids", [])) for i in gt_data["images"]}

        # the federated filter (eval.py:99-104)
        if self.federated:
            for img_id, cat_id in list(self.dts_by_img_cat):
                if cat_id not in self.img_nl.get(img_id, set()) and cat_id not in img_pl[img_id]:
                    del self.dts_by_img_cat[(img_id, cat_id)]

        # frequency groups (eval.py:107-114); without `frequency`, image_count bins
        self.freq_groups = [[], [], []]
        lbl = {"r": 0, "c": 1, "f": 2}
        for idx, cid in enumerate(self.cat_ids):
            cat = self.cats[cid]
            if "frequency" in cat:
                self.freq_groups[lbl[cat["frequency"]]].append(idx)
            else:
                n = cat.get("image_count", 100)
                self.freq_groups[0 if n < 10 else (1 if n < 100 else 2)].append(idx)

    def _mask_iou(self, dts, gts) -> np.ndarray:
        """The detections' RLEs and the ground truth's polygons or RLEs as
        bitmaps of the image, and their IoU."""
        if not dts or not gts:
            return np.zeros((len(dts), len(gts)))
        img = self.imgs[gts[0]["image_id"]]
        h, w = img["height"], img["width"]
        dm = np.stack([decode_rle(d["segmentation"]).reshape(-1) for d in dts])
        gm = np.stack([segmentation_to_mask(g["segmentation"], h, w).reshape(-1) for g in gts])
        return mask_iou_bitmaps(dm, gm)

    def _compute_iou(self, gts, dts):
        idx = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in idx]
        if self.iou_type == "bbox":
            return box_iou_xywh([d["bbox"] for d in dts], [g["bbox"] for g in gts])
        return self._mask_iou(dts, gts)

    def _evaluate_img(self, img_id, cat_id, area_rng, ious_sorted):
        gts = self.gts_by_img_cat.get((img_id, cat_id), [])
        dts = self.dts_by_img_cat.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        gt_ig0 = np.array(
            [1 if (g["ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]) else 0 for g in gts],
            np.int64,
        )
        gt_order = np.argsort(gt_ig0, kind="mergesort")
        gts_s = [gts[i] for i in gt_order]
        gt_ig = gt_ig0[gt_order]
        dts_s = [dts[i] for i in np.argsort([-d["score"] for d in dts], kind="mergesort")]
        ious = ious_sorted[:, gt_order] if len(gts) else ious_sorted

        t = len(IOU_THRS)
        ng, nd = len(gts_s), len(dts_s)
        gt_m = np.zeros((t, ng))
        dt_m = np.zeros((t, nd))
        dt_ig = np.zeros((t, nd))
        for ti, thr in enumerate(IOU_THRS):
            if nd == 0 or ng == 0:
                break
            for di in range(nd):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(ng):
                    if gt_m[ti, gi] > 0:
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dt_m[ti, di] = gts_s[m]["id"]
                gt_m[ti, m] = dts_s[di]["id"]

        nel = self.img_nel.get(img_id, set())
        dt_ig_mask = np.array(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] or d["category_id"] in nel for d in dts_s],
            bool,
        )[None, :].repeat(t, 0)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dt_m == 0, dt_ig_mask))
        return dict(
            dt_scores=np.array([d["score"] for d in dts_s]),
            dt_matches=dt_m,
            dt_ignore=dt_ig,
            gt_ignore=gt_ig,
        )

    def run(self) -> "OrderedDict[str, float]":
        t = len(IOU_THRS)
        r = len(REC_THRS)
        precision = -np.ones((t, r, len(self.cat_ids), len(AREA_RNG)))
        recall = -np.ones((t, len(self.cat_ids), len(AREA_RNG)))

        active_imgs: Dict[int, List[int]] = defaultdict(list)
        for img_id, cat_id in set(self.gts_by_img_cat) | set(self.dts_by_img_cat):
            active_imgs[cat_id].append(img_id)

        for ki, cat_id in enumerate(self.cat_ids):
            imgs = sorted(active_imgs.get(cat_id, []))
            if not imgs:
                continue
            per_img = []
            for img_id in imgs:
                gts = self.gts_by_img_cat.get((img_id, cat_id), [])
                dts = self.dts_by_img_cat.get((img_id, cat_id), [])
                per_img.append((img_id, self._compute_iou(gts, dts) if (gts or dts) else np.zeros((0, 0))))
            for ai, area_rng in enumerate(AREA_RNG):
                E = [self._evaluate_img(img_id, cat_id, area_rng, ious) for img_id, ious in per_img]
                E = [e for e in E if e is not None]
                if not E:
                    continue
                order = np.argsort(-np.concatenate([e["dt_scores"] for e in E]), kind="mergesort")
                dt_m = np.concatenate([e["dt_matches"] for e in E], axis=1)[:, order]
                dt_ig = np.concatenate([e["dt_ignore"] for e in E], axis=1)[:, order]
                gt_ig = np.concatenate([e["gt_ignore"] for e in E])
                num_gt = int(np.count_nonzero(gt_ig == 0))
                if num_gt == 0:
                    continue
                tps = np.logical_and(dt_m, np.logical_not(dt_ig))
                fps = np.logical_and(np.logical_not(dt_m), np.logical_not(dt_ig))
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(t):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    nd = len(tp)
                    rc = tp / num_gt
                    recall[ti, ki, ai] = rc[-1] if nd else 0
                    pr = tp / (fp + tp + np.spacing(1))
                    for i in range(nd - 1, 0, -1):  # the precision envelope
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    pr_at = np.zeros(r)
                    for ri, pi in enumerate(np.searchsorted(rc, REC_THRS, side="left")):
                        if pi >= nd:
                            break  # where the reference's try/except stops
                        pr_at[ri] = pr[pi]
                    precision[ti, :, ki, ai] = pr_at

        def summ(kind, iou_thr=None, area="all", freq=None):
            ai = AREA_LBL.index(area)
            s = precision if kind == "ap" else recall
            if iou_thr is not None:
                s = s[np.where(IOU_THRS == iou_thr)[0]]
            if kind == "ap":
                s = s[:, :, self.freq_groups[freq], ai] if freq is not None else s[:, :, :, ai]
            else:
                s = s[:, :, ai]
            valid = s[s > -1]
            return float(valid.mean()) if len(valid) else -1.0

        res = self.results
        res["AP"] = summ("ap")
        res["AP50"] = summ("ap", iou_thr=0.5)
        res["AP75"] = summ("ap", iou_thr=0.75)
        res["APs"] = summ("ap", area="small")
        res["APm"] = summ("ap", area="medium")
        res["APl"] = summ("ap", area="large")
        res["APr"] = summ("ap", freq=0)
        res["APc"] = summ("ap", freq=1)
        res["APf"] = summ("ap", freq=2)
        res[f"AR@{self.max_dets}"] = summ("ar")
        res[f"ARs@{self.max_dets}"] = summ("ar", area="small")
        res[f"ARm@{self.max_dets}"] = summ("ar", area="medium")
        res[f"ARl@{self.max_dets}"] = summ("ar", area="large")
        return res

    def table(self) -> str:
        """The results as the reference's markdown table (eval.py:485-527)."""
        lines = [
            "",
            "========================================================",
            "| Type | IoU | Area | MaxDets | CatIds | Result |",
            "| :---: | :---: | :---: | :---: | :---: | :---: |",
        ]
        for key, value in self.results.items():
            _type = "(AP)" if "AP" in key else "(AR)"
            if len(key) > 2 and key[2].isdigit():
                iou = f"{float(key[2:]) / 100:0.2f}"
            else:
                iou = f"{IOU_THRS[0]:0.2f}:{IOU_THRS[-1]:0.2f}"
            grp = key[2] if len(key) > 2 and key[2] in "rcf" else "all"
            area = key[2] if len(key) > 2 and key[2] in "sml" else "all"
            lines.append(
                f"| {_type:^6} | {iou:<9} | {area:>6s} | {self.max_dets:>3d} | {grp:>12s} | {value * 100:2.2f}% |"
            )
        return "\n".join(lines)

    def print_results(self) -> None:
        print(self.table())
