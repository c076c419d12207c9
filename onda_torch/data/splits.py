"""Domain splits of a metadata table (`onda_tpu/data/splits.py`)."""

from __future__ import annotations

from typing import Mapping, Sequence

from .metadata import Table


def get_split(table: Table, column: str, trainset: Sequence[Sequence],
              valset: Sequence[Sequence], restrictions: Mapping | None = None) -> dict:
    """Bucket rows into {"train": {set_: Table}, "val": {set_: Table}}.

    `trainset`/`valset` are lists of tuples of domain values (a set may merge
    several intensities). With no valset (the video streams) a train bucket
    takes the whole domain, ignoring the `set` column."""
    trainset = [tuple(pair) for pair in trainset]
    valset = [tuple(pair) for pair in valset]
    filtered = table
    for col, value in (restrictions or {}).items():
        filtered = filtered.where(col, [value])
    output = {"train": {}, "val": {}}
    for set_ in set(trainset) | set(valset):
        rows = filtered.where(column, set_)
        if set_ in trainset:
            output["train"][set_] = rows if not valset else rows.where("set", ["train"])
        if set_ in valset:
            output["val"][set_] = rows.where("set", ["val"])
    return output
