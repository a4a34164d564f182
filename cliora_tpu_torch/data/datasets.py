"""Per-example feature providers (host side).

The port's copy of cliora_tpu/data/datasets.py; ``FlickrDataset`` reads
its HDF5 features through one function, :func:`read_features`, or takes
the arrays from its caller.

``__getitem__`` returns ``(index, tokens, obj_feats, boxes, obj_cates)``
numpy tuples, matching the reference dataset contract
(reference: cliora/data/dataloader.py:116-225).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Sequence

import numpy as np

N_BOXES = 36
FEAT_DIM = 2048


class SimpleDataset:
    """Text-only; dummy visual slots (reference: dataloader.py:116-126)."""

    def __init__(self, sentences: Sequence):
        self.dataset = sentences

    def __getitem__(self, index):
        zero = np.zeros(1)
        return index, self.dataset[index], zero, zero, zero

    def __len__(self):
        return len(self.dataset)


class COCODataset:
    """COCO: region features disabled in the reference too
    (reference: dataloader.py:129-149)."""

    def __init__(self, sentences, img_ids=None):
        self.dataset = sentences
        self.img_ids = img_ids

    def __getitem__(self, index):
        stub = np.zeros(1, np.int32) - 1
        return index, self.dataset[index], stub, stub, stub

    def __len__(self):
        return len(self.dataset)


def read_features(data_path: str, mode: str):
    """``(features (N, 2048), bboxes (N, 4), pos_bboxes (n_imgs, 2))`` of
    ``{mode}_features_compress.hdf5``, read whole into RAM.  ``h5py`` is
    imported here, so a caller that hands :class:`FlickrDataset` its
    arrays needs no ``h5py``."""
    import h5py

    with h5py.File(os.path.join(
            data_path, f"{mode}_features_compress.hdf5"), "r") as h5:
        return (np.array(h5.get("features")), np.array(h5.get("bboxes")),
                np.array(h5.get("pos_bboxes")))


class FlickrDataset:
    """MAF Faster-R-CNN region features from HDF5, padded to 36 boxes.

    Loads the whole ``{mode}_features_compress.hdf5`` into RAM at init
    (datasets ``features`` (N, 2048), ``bboxes`` (N, 4), ``pos_bboxes``
    (n_imgs, 2) start/end rows) through :func:`read_features`, or takes
    those three arrays as ``features``, plus ``{mode}_imgid2idx.pkl``,
    ``{mode}_detection_dict.json`` and ``objects_vocab.txt`` (1600
    classes).  (reference: cliora/data/dataloader.py:188-225)
    """

    def __init__(self, sentences, img_ids, mode: str = "train",
                 data_path: str = "./flickr_data/flickr_feat_maf/",
                 features=None):
        self.dataset = sentences
        self.img_ids = img_ids
        with open(os.path.join(data_path, f"{mode}_imgid2idx.pkl"),
                  "rb") as f:
            self.imgid2idx = pickle.load(f)
        with open(os.path.join(data_path,
                               f"{mode}_detection_dict.json")) as f:
            self.detection_dict = json.load(f)
        with open(os.path.join(data_path, "objects_vocab.txt")) as f:
            self.obj2ind = {line.strip(): i for i, line in enumerate(f)}
        if features is None:
            features = read_features(data_path, mode)
        self.features, self.predicted_boxes, self.indexes = features
        self.n_boxes = N_BOXES
        self.feat_dim = int(self.features.shape[1])  # 2048 for real MAF

    def __getitem__(self, index):
        tokens = self.dataset[index]
        img_id = self.img_ids[index]
        row = self.imgid2idx[int(img_id)]
        start, end = self.indexes[row]
        num_box = min(end - start, self.n_boxes)

        boxes = np.full((self.n_boxes, 4), -1, np.float32)
        boxes[:num_box] = self.predicted_boxes[start:end][:num_box]
        obj_feats = np.zeros((self.n_boxes, self.feat_dim), np.float32)
        obj_feats[:num_box] = self.features[start:end][:num_box]
        obj_cates = np.full((self.n_boxes,), -1, np.int32)
        classes = self.detection_dict[str(img_id)]["classes"]
        obj_cates[:num_box] = np.asarray(
            [self.obj2ind.get(c, -1) for c in classes],
            np.int32)[:num_box]
        return index, tokens, obj_feats, boxes, obj_cates

    def __len__(self):
        return len(self.dataset)
