"""An HDF5-shaped tree held in memory, and the one opener that the package's
readers and writers share.

:func:`open_store` gives ``h5py.File(path, mode)`` for a path and the store
itself for a :class:`MemoryStore`. Everything that reads or writes the
deeprank layout (``Graph.write_to_hdf5``, ``Grid.to_hdf5``, the datasets'
indexing, feature checks, statistics and loads, the Trainer's cluster
writes) opens its file through it, so a :class:`MemoryStore` passed where a
path goes (``GraphDataset(hdf5_path=store)``,
``QueryCollection.process_in_memory``) runs the same code with no file and
no h5py: for machines without h5py.

The store keeps the part of h5py's surface that this code uses: groups
addressed by ``/``-separated paths and listed in name order (as h5py lists
them), ``create_group``/``require_group``/``create_dataset``/``del``, and
datasets read with ``[()]`` or slices (a copy, as h5py reads) and written
with ``ds[()] = value``. Storage options (``compression``, ``chunks``...)
are accepted and ignored: they are lossless in a file too. A store is a
shared resource, as a path names one file: ``copy.deepcopy`` of a dataset
that holds it keeps the same store.
"""

from __future__ import annotations

import numpy as np


class Dataset:
    """One array of a :class:`MemoryStore`."""

    __slots__ = ("_data",)

    def __init__(self, data):
        self._data = np.array(data)

    def __getitem__(self, key):
        out = self._data[key]
        return out.copy() if isinstance(out, np.ndarray) else out

    def __setitem__(self, key, value) -> None:
        self._data[key] = value

    def __len__(self) -> int:
        return len(self._data)

    @property
    def shape(self) -> tuple:
        return self._data.shape

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def dtype(self):
        return self._data.dtype


class Group:
    """Named groups and datasets, listed in name order."""

    def __init__(self):
        self._items: dict[str, Group | Dataset] = {}
        self.attrs: dict = {}

    @staticmethod
    def _parts(path: str) -> list[str]:
        return [p for p in path.split("/") if p]

    def _parent(self, path: str, create: bool) -> tuple[Group, str]:
        *head, leaf = self._parts(path)
        node = self
        for name in head:
            if name not in node._items and create:
                node._items[name] = Group()
            node = node._items[name]
            if not isinstance(node, Group):
                raise KeyError(path)
        return node, leaf

    def __getitem__(self, path: str):
        parent, leaf = self._parent(path, create=False)
        return parent._items[leaf]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self):
        return iter(sorted(self._items))

    def __len__(self) -> int:
        return len(self._items)

    def keys(self) -> list[str]:
        return sorted(self._items)

    def values(self) -> list:
        return [self._items[k] for k in sorted(self._items)]

    def items(self) -> list[tuple]:
        return [(k, self._items[k]) for k in sorted(self._items)]

    def _add(self, path: str, item):
        parent, leaf = self._parent(path, create=True)
        if leaf in parent._items:
            msg = f"unable to create {path!r}: the name already exists"
            raise ValueError(msg)
        parent._items[leaf] = item
        return item

    def create_group(self, path: str) -> Group:
        return self._add(path, Group())

    def require_group(self, path: str) -> Group:
        return self[path] if path in self else self.create_group(path)

    def create_dataset(self, path: str, data=None, **storage_options) -> Dataset:  # noqa: ARG002 — lossless in a file, nothing to do here
        return self._add(path, Dataset(data))

    def __delitem__(self, path: str) -> None:
        parent, leaf = self._parent(path, create=False)
        del parent._items[leaf]


class MemoryStore(Group):
    """The root of an in-memory deeprank file: entries by name, each laid out
    as ``QueryCollection.process`` writes it. Its own context manager, as
    an open file is."""

    def __enter__(self) -> MemoryStore:
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def __deepcopy__(self, memo) -> MemoryStore:  # noqa: ARG002
        return self

    def __repr__(self) -> str:
        return f"<MemoryStore of {len(self)} entries>"


def open_store(path, mode: str = "r"):
    """``h5py.File(path, mode)``, or ``path`` itself when it is a
    :class:`MemoryStore`."""
    if isinstance(path, MemoryStore):
        return path
    import h5py

    return h5py.File(path, mode)
