"""Corpus readers.

Each reader's ``read(path)`` returns::

    {"sentences": [[token, ...], ...],     # raw text tokens
     "extra":     {...per-example lists},  # ids, gold spans, grounding GT
     "metadata":  {...corpus-level info}}  # e.g. a fixed word2idx

File-layout conventions (sibling files resolved from the main path) follow
the reference so existing data directories work unchanged
(reference: cliora/data/reading.py).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np


def _filter_ok(tokens, filter_length: int) -> bool:
    return filter_length <= 0 or len(tokens) <= filter_length


def _sibling(path: str, name: str) -> str:
    return os.path.join(os.path.dirname(path), name)


def _split_of(path: str) -> str:
    base = os.path.basename(path)
    for split in ("train", "val", "test"):
        if split in base:
            return split
    raise NotImplementedError(f"cannot infer split from {path!r}")


def flatten_tree(tree) -> List:
    if not isinstance(tree, (list, tuple)):
        return [tree]
    out = []
    for node in tree:
        out.extend(flatten_tree(node))
    return out


class PlainTextReader:
    """One sentence per line (reference: reading.py:152-161)."""

    def __init__(self, lowercase=True, filter_length=0, delim=" ",
                 include_id=False):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0
        self.delim = delim
        self.include_id = include_id

    def read(self, path: str) -> Dict:
        sentences, example_ids = [], []
        with open(path) as f:
            for line in f:
                s = line.strip().split(self.delim)
                if self.include_id:
                    ex_id, s = s[0], s[1:]
                else:
                    ex_id = len(sentences)
                if not _filter_ok(s, self.filter_length):
                    continue
                if self.lowercase:
                    s = [w.lower() for w in s]
                example_ids.append(ex_id)
                sentences.append(s)
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids},
                "metadata": {}}


class JSONLReader:
    """jsonl of {example_id, tree[, sentence]} (reference: reading.py:164-202)."""

    def __init__(self, lowercase=True, filter_length=0):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0

    def read(self, path: str) -> Dict:
        sentences, example_ids, trees = [], [], []
        with open(path) as f:
            for line in f:
                ex = json.loads(line)
                tree = ex["tree"]
                s = ex.get("sentence") or flatten_tree(tree)
                if not _filter_ok(s, self.filter_length):
                    continue
                if self.lowercase:
                    s = [w.lower() for w in s]
                example_ids.append(ex["example_id"])
                sentences.append(s)
                trees.append(tree)
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids, "trees": trees},
                "metadata": {}}


def convert_binary_bracketing(parse: str, lowercase=True):
    """Binary-bracketed parse string -> (tokens, shift/reduce transitions).

    (reference: cliora/data/reading.py:32-47)
    """
    transitions, tokens = [], []
    for word in parse.split(" "):
        if word[0] == "(":
            continue
        if word == ")":
            transitions.append(1)
        else:
            tokens.append(word.lower() if lowercase else word)
            transitions.append(0)
    return tokens, transitions


class NLIReader:
    """SNLI-style jsonl: both sentences of each labeled pair.

    (reference: cliora/data/reading.py:205-274 NLIReader/
    NLISentenceReader)
    """

    LABEL_MAP = {"entailment": 0, "neutral": 1, "contradiction": 2}

    def __init__(self, lowercase=True, filter_length=0):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0

    def read(self, path: str) -> Dict:
        sentences, example_ids = [], []
        with open(path) as f:
            for line in f:
                ex = json.loads(line)
                if ex.get("gold_label") not in self.LABEL_MAP:
                    continue
                for part in ("1", "2"):
                    s, _ = convert_binary_bracketing(
                        ex[f"sentence{part}_binary_parse"],
                        lowercase=self.lowercase)
                    if not _filter_ok(s, self.filter_length):
                        continue
                    example_ids.append(ex["pairID"] + "_" + part)
                    sentences.append(s)
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids},
                "metadata": {}}


class ConllReader:
    """jsonl with entity spans (reference: reading.py:277-307)."""

    def __init__(self, lowercase=True, filter_length=0):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0

    def read(self, path: str) -> Dict:
        sentences, example_ids, entity_labels = [], [], []
        with open(path) as f:
            for line in f:
                data = json.loads(line)
                s = data["sentence"]
                if not _filter_ok(s, self.filter_length):
                    continue
                sentences.append(s)
                example_ids.append(data["example_id"])
                entity_labels.append(data["entities"])
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids,
                          "entity_labels": entity_labels},
                "metadata": {}}


class PTBReader:
    """Pickle with {'other_data': rows, 'word2idx'} (reference: reading.py:343-385)."""

    def __init__(self, lowercase=True, filter_length=0, delim=" "):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0
        self.delim = delim

    def read(self, path: str) -> Dict:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        word2idx = blob["word2idx"]
        sentences, example_ids, gts = [], [], []
        for idx, row in enumerate(blob["other_data"]):
            s = row[0].strip().split(self.delim)
            if not _filter_ok(s, self.filter_length):
                continue
            if self.lowercase:
                s = [w.lower() for w in s]
            s = [w if w in word2idx else "<unk>" for w in s]
            example_ids.append(idx)
            sentences.append(s)
            gts.append(row[5])
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids, "GT": gts},
                "metadata": {"word2idx": word2idx}}


class FlickrReader:
    """Flickr30K captions + gold spans + grounding GT.

    Main file: lines of json ``[sentence, gold_spans]``.  Siblings:
    ``flickr.dic.json`` (vocab), ``{split}.txt`` (imgid\\tsentid lines),
    ``gt_anno_{val,test}.pkl`` (grounding GT).
    (reference: cliora/data/reading.py:455-528)
    """

    def __init__(self, lowercase=True, filter_length=0, delim=" "):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0
        self.delim = delim

    def read(self, path: str) -> Dict:
        with open(_sibling(path, "flickr.dic.json")) as f:
            word2idx = json.load(f)
        split = _split_of(path)
        with open(_sibling(path, f"{split}.txt")) as f:
            img_sent_ids = [line.strip() for line in f]
        vg_anno: Optional[dict] = None
        if split in ("val", "test"):
            with open(_sibling(path, f"gt_anno_{split}.pkl"), "rb") as f:
                vg_anno = pickle.load(f)
        with open(path) as f:
            lines = f.readlines()
        assert len(img_sent_ids) == len(lines), (len(img_sent_ids),
                                                 len(lines))

        sentences, example_ids, gts, vg_gts, vis_feats = [], [], [], [], []
        for idx, line in enumerate(lines):
            sent, gt = json.loads(line.strip())
            s = sent.strip().split(self.delim)
            if not _filter_ok(s, self.filter_length):
                continue
            if self.lowercase:
                s = [w.lower() for w in s]
            s = [w if w in word2idx else "<unk>" for w in s]
            im_id, sent_id = img_sent_ids[idx].split("\t")
            example_ids.append(im_id)
            if vg_anno is not None:
                vg_gts.append(vg_anno.get(f"{im_id}_{sent_id}", [{}, None]))
            else:
                vg_gts.append([{}, None])
            sentences.append(s)
            gts.append([tuple(span) for span in gt])
            vis_feats.append(np.zeros(1))
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids,
                          "image_feats": vis_feats,
                          "GT": gts, "VG_GT": vg_gts},
                "metadata": {"word2idx": word2idx}}


class COCOReader:
    """COCO captions x5 + global image features (reference: reading.py:388-452)."""

    def __init__(self, lowercase=True, filter_length=0, delim=" "):
        self.lowercase = lowercase
        self.filter_length = filter_length or 0
        self.delim = delim

    def read(self, path: str) -> Dict:
        with open(_sibling(path, "coco.dict.json")) as f:
            word2idx = json.load(f)
        split = _split_of(path)
        with open(_sibling(path, os.path.join("id_list",
                                              f"{split}.txt"))) as f:
            img_ids = [int(line.strip(".jpg\n").split("_")[-1])
                       for line in f]
        img_ids = np.asarray(img_ids).repeat(5)
        if split == "test":
            image_feats = np.zeros([len(img_ids), 2048])
        else:
            image_feats = np.load(
                _sibling(path, f"{split}_ims.npy")).repeat(5, 0)
        with open(path) as f:
            lines = f.readlines()
        assert len(img_ids) == len(lines) == len(image_feats)

        sentences, example_ids, gts, vis_feats = [], [], [], []
        for idx, line in enumerate(lines):
            sent, gt = json.loads(line.strip())[:2]
            s = sent.strip().split(self.delim)
            if not _filter_ok(s, self.filter_length):
                continue
            if self.lowercase:
                s = [w.lower() for w in s]
            s = [w if w in word2idx else "<unk>" for w in s]
            example_ids.append(img_ids[idx])
            sentences.append(s)
            gts.append([tuple(span) for span in gt])
            vis_feats.append(image_feats[idx])
        return {"sentences": sentences,
                "extra": {"example_ids": example_ids,
                          "image_feats": vis_feats, "GT": gts},
                "metadata": {"word2idx": word2idx}}


class SyntheticReader:
    """Random-token corpus for smoke tests.

    (reference: reading.py:310-340 -- which is bit-rotted there: it
    references an undefined ``extra``; fixed here)
    """

    def __init__(self, nexamples=100, embedding_size=10, vocab_size=14,
                 seed=11, minlen=10, maxlen=20, length=None):
        self.nexamples = nexamples
        self.embedding_size = embedding_size
        self.vocab_size = vocab_size
        self.seed = seed
        self.minlen, self.maxlen = minlen, maxlen
        self.length = length

    def read(self, path=None) -> Dict:
        lo = self.length if self.length is not None else self.minlen
        hi = (self.length + 1) if self.length is not None else self.maxlen
        rs = np.random.RandomState(self.seed)
        sentences = [
            [str(t) for t in rs.randint(0, self.vocab_size,
                                        size=rs.randint(lo, hi))]
            for _ in range(self.nexamples)
        ]
        metadata = {
            "embeddings": rs.randn(
                self.vocab_size, self.embedding_size).astype(np.float32),
            "word2idx": {str(i): i for i in range(self.vocab_size)},
        }
        return {"sentences": sentences,
                "extra": {"example_ids": list(range(len(sentences)))},
                "metadata": metadata}
