"""Metadata tables of the weather-Cityscapes datasets (`onda_tpu/data/metadata.py`),
without pandas.

A table is the JSON that pandas' `DataFrame.to_json` writes ("columns"
orientation: `{"image_path": {"0": ..., "1": ...}, ...}`), with the columns
image_path, label_path (null for label-less frames), set (train / val) and a
domain column (`intensity` or `scene`). `Table` keeps its rows in the file's
key order, which is the order pandas' `read_json` gives them, and offers what
the splits and the CLI need: filters, concatenation, row selection and
pandas' `sample` draw.
"""

from __future__ import annotations

import json
import os

import numpy as np


class Table:
    """Rows of a metadata table in order, each a dict of column → value."""

    def __init__(self, rows, columns):
        self.rows = list(rows)
        self.columns = list(columns)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        return self.rows[i]

    def column(self, name) -> list:
        return [row[name] for row in self.rows]

    def where(self, column, values) -> "Table":
        """The rows whose `column` is in `values`, in order."""
        values = set(values)
        return Table((r for r in self.rows if r[column] in values), self.columns)

    def take(self, indices) -> "Table":
        return Table((self.rows[int(i)] for i in indices), self.columns)

    @staticmethod
    def concat(tables) -> "Table":
        tables = list(tables)
        columns = list(dict.fromkeys(c for t in tables for c in t.columns))
        return Table((r for t in tables for r in t.rows), columns)

    def sample(self, n: int | None = None, frac: float | None = None,
               random_state: int = 0) -> "Table":
        """pandas' `DataFrame.sample` without replacement: the same rows in the
        same order (`RandomState(random_state).choice(len, size, replace=False)`,
        with size `round(frac * len)` for a fraction)."""
        if (n is None) == (frac is None):
            raise ValueError("give n or frac")
        if frac is not None:
            if not 0 <= frac <= 1:
                raise ValueError(f"frac must be in [0, 1] without replacement, got {frac}")
            n = round(frac * len(self))
        if n < 0 or n > len(self):
            raise ValueError(f"cannot sample {n} of {len(self)} rows without replacement")
        rows = np.random.RandomState(random_state).choice(len(self), size=n, replace=False)
        return self.take(rows)

    def to_json(self, path: str) -> None:
        """Write the table in pandas' "columns" orientation."""
        data = {c: {str(i): row.get(c) for i, row in enumerate(self.rows)} for c in self.columns}
        with open(path, "w") as f:
            json.dump(data, f, separators=(",", ":"))


def load_table(path: str) -> Table:
    """Read a metadata JSON in pandas' "columns" orientation; rows keep the
    file's key order (the keys are index labels: never sorted as strings)."""
    with open(path) as f:
        data = json.load(f)
    columns = list(data)
    if not columns:
        return Table([], [])
    keys = list(data[columns[0]])
    for c in columns:
        if list(data[c]) != keys:
            raise ValueError(f"{path}: column {c!r} has other row labels than {columns[0]!r}")
    return Table(({c: data[c][k] for c in columns} for k in keys), columns)


def load_dataset_info(path: str | None = None) -> dict:
    """The 19-class Cityscapes schema (label2train remap, names, palette,
    mean/std) with `classnum_to_label` added, as the reference's database
    handler does."""
    if path is None:
        path = os.path.join(os.path.dirname(__file__), "cityscapes_info.json")
    with open(path) as f:
        info = json.load(f)
    info["classnum_to_label"] = dict(enumerate(info["label"]))
    return info
