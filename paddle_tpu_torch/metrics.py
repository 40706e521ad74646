"""Host-side metric accumulators (reference: python/paddle/fluid/metrics.py),
the port's copy of ``paddle_tpu/metrics.py``: numpy on the host, fed with a
step's fetches."""
from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *a, **kw):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no samples accumulated")
        return self.value / self.weight


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Histogram-bucket streaming AUC (host mirror of the in-graph auc op)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self.stat_pos = np.zeros(self.num_thresholds + 1)
        self.stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        p = preds[:, -1] if preds.ndim > 1 else preds
        bucket = np.clip((p * self.num_thresholds).astype(int), 0,
                         self.num_thresholds)
        for b, l in zip(bucket, labels):
            if l > 0:
                self.stat_pos[b] += 1
            else:
                self.stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self.stat_pos[::-1])
        fp = np.cumsum(self.stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        tpr0 = np.concatenate([[0.0], tpr[:-1]])
        fpr0 = np.concatenate([[0.0], fpr[:-1]])
        return float(np.sum((fpr - fpr0) * (tpr + tpr0) / 2.0))


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def update(self, distances, seq_num):
        self.total += float(np.sum(np.asarray(distances)))
        self.count += int(seq_num)

    def eval(self):
        return self.total / self.count if self.count else 0.0


class ChunkEvaluator(MetricBase):
    """Chunk-level precision/recall/F1 for sequence labeling (reference
    metrics.py:513 over the chunk_eval op). Host-side: update() takes the
    per-batch chunk counts; ``extract_chunks``/``count`` helpers compute
    them from IOB-tagged id sequences (the op itself is scoped out,
    SCOPE.md)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    @staticmethod
    def extract_chunks(tags, num_chunk_types, scheme="IOB"):
        """[T] tag ids -> set of (type, start, end) chunks. Tag layout is the
        reference's: tag = chunk_type * tag_per_chunk + position, IOB:
        B=0, I=1 within each type."""
        if scheme != "IOB":
            raise NotImplementedError("IOB only (IOE/IOBES: open a chunk "
                                      "type in SCOPE.md if needed)")
        chunks = []
        start, ctype = None, None
        n_tag = 2 * num_chunk_types   # ids >= this (or < 0) are O/padding
        for i, t in enumerate(list(tags) + [-1]):
            if 0 <= t < n_tag:
                typ, pos = int(t) // 2, int(t) % 2
            else:
                t, typ, pos = -1, None, None
            if start is not None and (t < 0 or pos == 0 or typ != ctype):
                chunks.append((ctype, start, i))
                start, ctype = None, None
            if t >= 0 and pos == 0:
                start, ctype = i, typ
            elif t >= 0 and pos == 1 and start is None:
                start, ctype = i, typ    # I without B opens a chunk (lenient)
        return set(chunks)

    def count(self, inferred_tags, label_tags, num_chunk_types):
        """Convenience: update() from two padded tag id arrays [T] (-1 pad)."""
        inf = self.extract_chunks(inferred_tags, num_chunk_types)
        lab = self.extract_chunks(label_tags, num_chunk_types)
        self.update(len(inf), len(lab), len(inf & lab))

    def eval(self):
        p = (self.num_correct_chunks / self.num_infer_chunks
             if self.num_infer_chunks else 0.0)
        r = (self.num_correct_chunks / self.num_label_chunks
             if self.num_label_chunks else 0.0)
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference metrics.py:805 +
    operators/detection/detection_map_op). Host-side over the framework's
    fixed-shape multiclass_nms output: update() takes the padded
    [K, 6] (label, score, x1, y1, x2, y2) detections (label=-1 padding
    ignored) and ground truth [G, 5] (label, x1, y1, x2, y2) per image."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = {}    # class -> list of (score, tp)
        self._n_gt = {}    # class -> count

    @staticmethod
    def _iou(a, b):
        ax = max(a[0], b[0]); ay = max(a[1], b[1])
        bx = min(a[2], b[2]); by = min(a[3], b[3])
        inter = max(bx - ax, 0) * max(by - ay, 0)
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gt):
        detections = np.asarray(detections)
        gt = np.asarray(gt)
        for row in gt:
            self._n_gt[int(row[0])] = self._n_gt.get(int(row[0]), 0) + 1
        used = set()
        order = np.argsort(-detections[:, 1])
        for i in order:
            lab = int(detections[i, 0])
            if lab < 0:
                continue
            box = detections[i, 2:6]
            # reference detection_map_op semantics: take the argmax-IoU gt of
            # the class (used or not); if that gt was already matched by a
            # higher-scoring detection, this one is a false positive
            best, best_j = 0.0, -1
            for j, g in enumerate(gt):
                if int(g[0]) != lab:
                    continue
                iou = self._iou(box, g[1:5])
                if iou > best:
                    best, best_j = iou, j
            tp = best >= self.overlap_threshold and best_j not in used
            if tp:
                used.add(best_j)
            self._dets.setdefault(lab, []).append(
                (float(detections[i, 1]), tp))

    def eval(self):
        aps = []
        for lab, n_gt in self._n_gt.items():
            dets = sorted(self._dets.get(lab, []), reverse=True)
            if not dets or n_gt == 0:
                aps.append(0.0)
                continue
            tp_cum = np.cumsum([d[1] for d in dets])
            fp_cum = np.cumsum([not d[1] for d in dets])
            recall = tp_cum / n_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
            if self.ap_version == "11point":
                ap = float(np.mean([precision[recall >= t].max()
                                    if (recall >= t).any() else 0.0
                                    for t in np.linspace(0, 1, 11)]))
            else:   # integral
                ap = float(np.sum((recall[1:] - recall[:-1]) *
                                  precision[1:])) + float(
                    recall[0] * precision[0])
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
