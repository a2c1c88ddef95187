"""The abdominal organ class table and its colours.

The port's own copy of what it needs from `jointimagegeneration_tpu/data/
classes.py`: 12 classes (background 0, ten TotalSegmentator organs, the
colorectal tumour 11) with the colours the panels paint them in.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

__all__ = ["OrganClass", "ABD_ORGAN_CLASSES", "NUM_CLASSES", "class_color_map", "labels_to_colors"]


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


def class_color_map() -> np.ndarray:
    """(C, 3) uint8 colour table."""
    return np.asarray([c.color for c in ABD_ORGAN_CLASSES], dtype=np.uint8)


def labels_to_colors(labels: np.ndarray) -> np.ndarray:
    """Integer label array -> RGB uint8 (..., 3)."""
    return class_color_map()[np.clip(labels, 0, NUM_CLASSES - 1)]
