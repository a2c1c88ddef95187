"""The abdominal organ class table, its colours and the label remap.

The port's own copy of `jointimagegeneration_tpu/data/classes.py`: 12 classes
(background 0, ten TotalSegmentator organs, the colorectal tumour 11) with the
colours the panels paint them in, and the remap of a TotalSegmentator label
volume onto them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["OrganClass", "ABD_ORGAN_CLASSES", "NUM_CLASSES", "TOTALSEG_DESIGNATED_LABELS", "remap_totalseg_labels",
           "class_color_map", "labels_to_colors"]


class OrganClass(NamedTuple):
    label_name: str
    totalseg_id: int
    color: Tuple[int, int, int]


ABD_ORGAN_CLASSES: List[OrganClass] = [
    OrganClass("unlabeled", 0, (0, 0, 0)),
    OrganClass("spleen", 1, (0, 80, 100)),
    OrganClass("kidney_left", 2, (119, 11, 32)),
    OrganClass("kidney_right", 3, (119, 11, 32)),
    OrganClass("liver", 5, (250, 170, 30)),
    OrganClass("stomach", 6, (220, 220, 0)),
    OrganClass("pancreas", 10, (107, 142, 35)),
    OrganClass("small_bowel", 55, (255, 0, 0)),
    OrganClass("duodenum", 56, (70, 130, 180)),
    OrganClass("colon", 57, (0, 0, 255)),
    OrganClass("urinary_bladder", 104, (0, 255, 255)),
    OrganClass("colorectal_cancer", 255, (0, 255, 0)),
]

NUM_CLASSES = len(ABD_ORGAN_CLASSES)  # 12

# the TotalSegmentator ids that become classes 1..10, in order
TOTALSEG_DESIGNATED_LABELS = (1, 2, 3, 5, 6, 10, 55, 56, 57, 104)
_UINT8_LUT = np.zeros(256, np.int32)
_UINT8_LUT[list(TOTALSEG_DESIGNATED_LABELS)] = np.arange(1, len(TOTALSEG_DESIGNATED_LABELS) + 1)


def remap_totalseg_labels(label: np.ndarray, tumor_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """TotalSegmentator label volume -> int32 class ids (other ids -> 0);
    voxels where `tumor_mask` > 0 become the last class.  A uint8 volume
    goes through a lookup table in one pass."""
    label = np.asarray(label)
    if label.dtype == np.uint8:
        out = _UINT8_LUT[label]
    else:
        out = np.zeros(label.shape, np.int32)
        for i, tid in enumerate(TOTALSEG_DESIGNATED_LABELS):
            out[label == tid] = i + 1
    if tumor_mask is not None:
        out[np.asarray(tumor_mask) > 0] = NUM_CLASSES - 1
    return out


def class_color_map() -> np.ndarray:
    """(C, 3) uint8 colour table."""
    return np.asarray([c.color for c in ABD_ORGAN_CLASSES], dtype=np.uint8)


def labels_to_colors(labels: np.ndarray) -> np.ndarray:
    """Integer label array -> RGB uint8 (..., 3)."""
    return class_color_map()[np.clip(labels, 0, NUM_CLASSES - 1)]
