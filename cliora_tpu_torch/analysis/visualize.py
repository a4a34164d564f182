"""Draw per-word best-region boxes on images (cv2).

The port's copy of cliora_tpu/analysis/visualize.py.
(reference: cliora/net/trainer.py:307-334 ``Net.visualization``)
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

COLOURS = [
    (255, 0, 0), (0, 255, 0), (165, 42, 42), (255, 170, 170),
    (255, 255, 255), (0, 127, 255), (127, 0, 255), (127, 255, 0),
    (255, 127, 0), (255, 0, 127), (0, 0, 255), (127, 255, 255),
    (255, 127, 255), (255, 255, 127), (127, 255, 127), (255, 127, 127),
    (127, 127, 255), (127, 0, 63), (102, 102, 102), (64, 192, 192),
    (192, 64, 192), (192, 192, 64), (64, 64, 192), (64, 192, 64),
    (192, 64, 64),
]


def visualize_batch(atten_score: np.ndarray, tokens: np.ndarray,
                    img_ids: Sequence, boxes: np.ndarray,
                    idx2word: Dict[int, str],
                    img_root: str = "./flickr_data/",
                    out_dir: str = None):
    """Write annotated images to ``{img_root}/visualize/{img_id}.jpg``.

    atten_score: (B, L, R); boxes: (B, R, 4); tokens: (B, L) int ids.
    """
    import cv2

    out_dir = out_dir or os.path.join(img_root, "visualize")
    os.makedirs(out_dir, exist_ok=True)
    atten_score = np.asarray(atten_score)
    max_idx = atten_score.argmax(-1)
    max_prob = atten_score.max(-1)

    written = []
    for bid, img_id in enumerate(img_ids):
        path = os.path.join(img_root, "flickr30k_images", f"{img_id}.jpg")
        img = cv2.imread(path)
        if img is None:
            continue
        box_ids = max_idx[bid].tolist()
        box2color = {idx: i for i, idx in enumerate(set(box_ids))}
        if len(box2color) > len(COLOURS):
            continue
        words = [idx2word[i] for i in np.asarray(tokens)[bid].tolist()]
        for pos, word in enumerate(words):
            box_id = box_ids[pos]
            color = COLOURS[box2color[box_id]]
            x1, y1, x2, y2 = [int(v) for v in boxes[bid][box_id]]
            img = cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            label = f"{word}   {round(float(max_prob[bid][pos]), 2)}"
            img = cv2.putText(img, label, (10, 18 * (pos + 1)),
                              cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2)
        out_path = os.path.join(out_dir, f"{img_id}.jpg")
        cv2.imwrite(out_path, img)
        written.append(out_path)
    return written
