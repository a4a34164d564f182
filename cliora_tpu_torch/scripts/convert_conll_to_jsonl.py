"""Convert CoNLL BIO files to the jsonl format the ConllReader consumes.

Each sentence becomes ``{example_id, entities: [[label, pos, size], ...],
sentence: [words]}``; malformed I-tags are coerced to B with a warning,
matching the reference converter's tolerance.  The port's copy of
cliora_tpu/scripts/convert_conll_to_jsonl.py (pure Python).
(reference: cliora/misc/convert_conll_to_jsonl.py)
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, List, Tuple


def parse_bio_tag(tag: str) -> Tuple[str, str]:
    if tag.startswith("O"):
        return "O", None
    if tag[0] in ("B", "I") and "-" in tag:
        head, label = tag.split("-", 1)
        return head, label
    raise ValueError(f"Not a BIO tag: {tag}")


def sentences_from_conll(path: str, delim: str = " ", i_word: int = 0,
                         i_tag: int = 2) -> Iterator[List[Tuple[str, str, str]]]:
    rows: List[Tuple[str, str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                if rows:
                    yield rows
                    rows = []
                continue
            parts = line.split(delim)
            tag, label = parse_bio_tag(parts[i_tag])
            rows.append((parts[i_word], tag, label))
    if rows:
        yield rows


def rows_to_example(rows, example_id: str) -> dict:
    words = [w for w, _, _ in rows]
    entities, warnings = [], []
    for i, (_, tag, label) in enumerate(rows):
        if tag == "I":
            # I without a directly-preceding entity opens a new one
            if not entities or entities[-1][1] + entities[-1][2] != i:
                warnings.append(
                    f"[warning] Converting I to B. i = {i}")
                tag = "B"
        if tag == "O":
            continue
        if tag == "B":
            assert label is not None
            entities.append([label, i, 1])
        else:  # I extends the open entity
            entities[-1][2] += 1
    example = {"example_id": example_id, "entities": entities,
               "sentence": words}
    if warnings:
        example["warnings"] = warnings
    return example


def main(args=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", default="./train.txt", type=str)
    p.add_argument("--delim", default=" ", type=str)
    p.add_argument("--i_word", default=0, type=int)
    p.add_argument("--i_tag", default=2, type=int)
    p.add_argument("--name", default="conll2000", type=str)
    options = p.parse_args(args)

    for i, rows in enumerate(sentences_from_conll(
            options.path, options.delim, options.i_word, options.i_tag)):
        print(json.dumps(rows_to_example(rows, f"{options.name}_{i}")))


if __name__ == "__main__":
    main()
