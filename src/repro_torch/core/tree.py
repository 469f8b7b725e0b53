"""Host-side leaf-oriented iSAX tree with fat leaves (paper Section V-B1).

The port's copy of `repro.core.tree`: host code (numpy and threads) on
the port's `core.isax`.

The novelty of FreSh's tree is that multiple inserts may concurrently update
the SAME fat leaf's data array D:

  * each leaf has a counter `elements`; an inserter reserves a position with
    FAI and writes its entry into D[pos] — no copying of the leaf;
  * each leaf has an `announce` array with one slot per thread; in STANDARD
    mode a thread announces its operation before reserving, so a concurrent
    split can redistribute entries that were reserved but not yet written;
  * a full leaf is split into an internal node + two leaves (round-robin
    segment, one more bit of cardinality), installed with CAS on the parent
    child pointer; empty-sided splits repeat (Section II).

Modes (Section IV): in EXPEDITIVE mode the owner skips the announce-array
write (it is the only thread in its subtree, so no concurrent split can miss
its entry); when a helper raises the subtree/leaf help flag the owner
switches to STANDARD.  This mirrors the performance-breakdown variants of
Figure 6b-c (FreSh vs Subtree vs Standard vs TreeCopy).

CAS emulation: CPython bytecode interleaves, so `if p.x is old: p.x = new`
is not atomic.  `_cas(obj, attr, old, new)` wraps the two-step compare+swap
in a module-level lock held O(1) — it models a single hardware CAS
instruction (never held across payload work), not a data-structure lock.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from . import isax

_CAS_LOCK = threading.Lock()


def _cas(obj: Any, attr: str, old: Any, new: Any) -> bool:
    """Emulated hardware CAS on an attribute."""
    with _CAS_LOCK:
        if getattr(obj, attr) is old:
            setattr(obj, attr, new)
            return True
        return False


def cas_min(box: List[float], value: float) -> bool:
    """The paper's BSF update: CAS-loop min on a shared cell (Section V-C)."""
    while True:
        cur = box[0]
        if value >= cur:
            return False
        with _CAS_LOCK:
            if box[0] == cur:
                box[0] = value
                return True
        # else: retry with the fresher value


class _Node:
    __slots__ = ("depths",)

    def __init__(self, depths: np.ndarray):
        # depths[s] = number of symbol bits of segment s fixed by this node
        self.depths = depths


class Internal(_Node):
    __slots__ = ("split_seg", "left", "right", "_left_box", "_right_box")

    def __init__(self, depths, split_seg, left, right):
        super().__init__(depths)
        self.split_seg = split_seg
        self.left = left
        self.right = right


class Leaf(_Node):
    __slots__ = ("capacity", "data", "elements", "announce", "n_threads",
                 "help_flag", "frozen")

    def __init__(self, depths, capacity: int, n_threads: int):
        super().__init__(depths)
        self.capacity = capacity
        self.data: List[Optional[Tuple[np.ndarray, int]]] = [None] * capacity
        self.elements = _FAI()
        self.announce: List[Optional[Tuple[np.ndarray, int]]] = [None] * n_threads
        self.n_threads = n_threads
        self.help_flag = False   # a helper reached this leaf -> standard mode
        self.frozen = False      # set during split: no more reservations honored


class _FAI:
    """Fetch-and-increment (GIL-atomic via itertools-free implementation)."""

    __slots__ = ("_v", )

    def __init__(self):
        self._v = 0

    def fai(self) -> int:
        with _CAS_LOCK:   # models one hardware FAI instruction
            v = self._v
            self._v = v + 1
            return v

    def read(self) -> int:
        return self._v


class FatLeafTree:
    """One root subtree of the iSAX forest (lock-free fat-leaf tree)."""

    def __init__(self, segments: int = isax.SEGMENTS, bits: int = isax.SAX_BITS,
                 leaf_capacity: int = 64, n_threads: int = 8):
        self.segments = segments
        self.bits = bits
        self.leaf_capacity = leaf_capacity
        self.n_threads = n_threads
        # root region: 1 bit fixed per segment (the root-bucket signature)
        self.root: _Node = Leaf(np.ones(segments, dtype=np.int32),
                                leaf_capacity, n_threads)
        self._root_box = _Box(self.root)

    # ------------------------------------------------------------ inserts
    def insert(self, tid: int, word: np.ndarray, payload: int,
               mode: str = "standard") -> None:
        """Insert (iSAX word, payload).  Retries across splits (lock-free)."""
        while True:
            parent_box, node = self._descend(word)
            if isinstance(node, Internal):
                continue  # raced with a split; descend again
            leaf: Leaf = node
            if mode == "helping":
                # a helper reached this leaf: owner must switch to standard
                # (FreSh's per-leaf mode granularity, Figure 6b-c)
                leaf.help_flag = True
            standard = (mode != "expeditive") or leaf.help_flag
            if standard:
                leaf.announce[tid] = (word, payload)
            pos = leaf.elements.fai()
            if pos < leaf.capacity and not leaf.frozen:
                leaf.data[pos] = (word, payload)
                if standard:
                    leaf.announce[tid] = None
                return
            # leaf full (or frozen under a racing split): split and retry
            self._split(parent_box, leaf)
            if standard:
                leaf.announce[tid] = None
            # loop: descend again; our announced entry was redistributed by
            # the split if it happened to be picked up, so re-check:
            if standard and self._contains(word, payload):
                return

    def _descend(self, word: np.ndarray) -> Tuple["_Box", _Node]:
        box = self._root_box
        node = box.get()
        while isinstance(node, Internal):
            s = node.split_seg
            # node.depths[s] bits of segment s are fixed ABOVE this node;
            # its children discriminate on the NEXT bit (depths[s] + 1) —
            # must match _build_split's partitioning depth exactly.
            d = node.depths[s] + 1
            bit = (int(word[s]) >> (self.bits - d)) & 1
            box = node._right_box if bit else node._left_box  # type: ignore
            node = box.get()
        return box, node

    # -------------------------------------------------------------- split
    def _split(self, parent_box: "_Box", leaf: Leaf) -> None:
        if parent_box.get() is not leaf:
            return  # someone already replaced it
        leaf.frozen = True
        # gather entries: filled D slots + all announced-but-unwritten ops
        entries: List[Tuple[np.ndarray, int]] = []
        seen = set()
        for e in leaf.data:
            if e is not None and (id_key := (int(e[1]),)) not in seen:
                seen.add(id_key)
                entries.append(e)
        for e in leaf.announce:
            if e is not None and (int(e[1]),) not in seen:
                seen.add((int(e[1]),))
                entries.append(e)
        new_sub = self._build_split(leaf.depths, entries)
        _cas_box(parent_box, leaf, new_sub)

    def _build_split(self, depths: np.ndarray,
                     entries: Sequence[Tuple[np.ndarray, int]]) -> _Node:
        """Split on the round-robin next segment; repeat while one side empty
        (Section II: 'If one of the newly created leaves is empty, the
        splitting process is repeated')."""
        depths = depths.copy()
        while True:
            s = int(np.argmin(depths))       # round-robin: least-fixed segment
            if depths[s] >= self.bits:
                # cannot split further: overflow leaf with doubled capacity
                big = Leaf(depths, max(len(entries), 1) * 2, self.n_threads)
                for i, e in enumerate(entries):
                    big.data[i] = e
                big.elements._v = len(entries)
                return big
            d = depths[s] + 1
            child_depths = depths.copy()
            child_depths[s] = d
            bits = [((int(w[s]) >> (self.bits - d)) & 1) for (w, _) in entries]
            left_e = [e for e, b in zip(entries, bits) if b == 0]
            right_e = [e for e, b in zip(entries, bits) if b == 1]
            if left_e and right_e or len(entries) <= self.leaf_capacity:
                left = self._make_leaf(child_depths, left_e)
                right = self._make_leaf(child_depths, right_e)
                node = Internal(depths, s, left, right)
                node._left_box = _Box(left)     # type: ignore[attr-defined]
                node._right_box = _Box(right)   # type: ignore[attr-defined]
                return node
            # one side empty and still over capacity: descend directly
            depths = child_depths
            entries = left_e or right_e

    def _make_leaf(self, depths: np.ndarray,
                   entries: Sequence[Tuple[np.ndarray, int]]) -> _Node:
        if len(entries) > self.leaf_capacity:
            return self._build_split(depths, entries)
        leaf = Leaf(depths, self.leaf_capacity, self.n_threads)
        for i, e in enumerate(entries):
            leaf.data[i] = e
        leaf.elements._v = len(entries)
        return leaf

    # ----------------------------------------------------------- queries
    def _contains(self, word: np.ndarray, payload: int) -> bool:
        _, node = self._descend(word)
        if isinstance(node, Leaf):
            return any(e is not None and e[1] == payload
                       for e in list(node.data) + list(node.announce))
        return False

    def leaves(self) -> List[Leaf]:
        out: List[Leaf] = []
        stack = [self._root_box.get()]
        while stack:
            n = stack.pop()
            if isinstance(n, Internal):
                stack.append(n._left_box.get())    # type: ignore
                stack.append(n._right_box.get())   # type: ignore
            else:
                out.append(n)
        return out

    def items(self) -> List[Tuple[np.ndarray, int]]:
        out = []
        for leaf in self.leaves():
            for e in leaf.data:
                if e is not None:
                    out.append(e)
        return out

    def inorder_nodes(self) -> List[_Node]:
        """In-order node listing — the PS stage's per-node work assignment
        (the paper keeps per-node left-subtree counters to find the i-th
        node; post-build we can materialize the order directly since the
        non-overlapping property guarantees construction has finished)."""
        out: List[_Node] = []

        def rec(n: _Node) -> None:
            if isinstance(n, Internal):
                rec(n._left_box.get())    # type: ignore
                out.append(n)
                rec(n._right_box.get())   # type: ignore
            else:
                out.append(n)

        rec(self._root_box.get())
        return out


class _Box:
    """A mutable cell supporting CAS (a child-pointer slot)."""

    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def get(self):
        return self._v


def _cas_box(box: _Box, old, new) -> bool:
    with _CAS_LOCK:
        if box._v is old:
            box._v = new
            return True
        return False
