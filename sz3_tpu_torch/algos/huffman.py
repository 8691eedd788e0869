"""Huffman tree and code tables of a histogram, for trees deeper than 32
levels.

The host engine's ``runtime.huff_table`` builds the reference tree
(HuffmanEncoder.hpp) but exports codes of at most 32 bits, and refuses
deeper trees with ``DeepTreeError``. The device packer takes codes of up to
64 bits, so such a tree stays on the device path: :func:`build_table`
builds the same tree here, with the reference's exact heap and tie
semantics (csrc/engine/szt/huffman.hpp, ``build_from_freq``,
``assign_codes`` and ``save``), and returns what ``huff_table`` returns.
A deep tree is rare (its counts must grow like the Fibonacci numbers over
33 levels, so the stream holds at least 9 million symbols), so this plain
Python build costs nothing on the common path.
"""

from __future__ import annotations

import struct

import numpy as np


def build_table(offset: int, freq: np.ndarray):
    """(offset, freq) in the reference convention (freq[s] = count of symbol
    offset+s, with a trailing zero slot) -> (codes uint64 right-aligned, lens
    uint8, serialized tree bytes), as ``runtime.huff_table`` gives them, for
    codes of up to 64 bits."""
    state_num = int(freq.size)
    pool_freq, pool_sym, pool_l, pool_r = [], [], [], []

    def new_node(f, sym, left, right):
        pool_freq.append(f)
        pool_sym.append(sym)
        pool_l.append(left)
        pool_r.append(right)
        return len(pool_freq) - 1

    heap = [-1]                                  # heap[0] unused; root at index 1

    def push(n):
        i = len(heap)
        heap.append(-1)
        while i > 1:
            j = i >> 1
            if pool_freq[heap[j]] <= pool_freq[n]:
                break
            heap[i] = heap[j]
            i = j
        heap[i] = n

    def pop():
        n = heap[1]
        last = heap.pop()
        qend = len(heap)
        if qend > 1:
            heap[1] = last
            i = 1
            while True:
                c = i << 1
                if c >= qend:
                    break
                if c + 1 < qend and pool_freq[heap[c + 1]] < pool_freq[heap[c]]:
                    c += 1
                if pool_freq[heap[i]] > pool_freq[heap[c]]:
                    heap[i], heap[c] = heap[c], heap[i]
                    i = c
                else:
                    break
        return n

    # leaves enter the heap in symbol order, as in the reference
    for s in np.flatnonzero(freq):
        push(new_node(int(freq[s]), int(s), -1, -1))
    if len(heap) < 2:
        raise ValueError("huffman: no symbols")
    while len(heap) > 2:
        left = pop()
        right = pop()
        push(new_node(pool_freq[left] + pool_freq[right], 0, left, right))
    root = heap[1]

    codes = np.zeros(state_num, np.uint64)
    lens = np.zeros(state_num, np.uint8)
    stack = [(root, 0, 0)]
    while stack:
        node, length, code = stack.pop()
        if pool_l[node] < 0:
            if length > 64:
                raise ValueError(f"huffman code of {length} bits exceeds 64")
            codes[pool_sym[node]] = code
            lens[pool_sym[node]] = length
            continue
        stack.append((pool_l[node], length + 1, code << 1))
        stack.append((pool_r[node], length + 1, (code << 1) | 1))

    # serialized tree: [offset i32][nodeCount BE u32][stateNum/2 BE u32]
    # [endian byte 0][L][R][C i32][t u8], nodes numbered in preorder
    count = len(pool_freq)
    L = np.zeros(count, np.int64)
    R = np.zeros(count, np.int64)
    C = np.zeros(count, "<i4")
    t = np.zeros(count, np.uint8)
    slot_next = 0

    def preorder(node, slot):                # depth <= 64, checked above
        nonlocal slot_next
        C[slot] = pool_sym[node]
        t[slot] = pool_l[node] < 0
        if pool_l[node] >= 0:
            slot_next += 1
            L[slot] = slot_next
            preorder(pool_l[node], slot_next)
            slot_next += 1
            R[slot] = slot_next
            preorder(pool_r[node], slot_next)

    preorder(root, 0)
    idx = "<u1" if count <= 256 else "<u2" if count <= 65536 else "<u4"
    tree = b"".join([struct.pack("<i", offset), struct.pack(">II", count, state_num // 2),
                     b"\x00", L.astype(idx).tobytes(), R.astype(idx).tobytes(),
                     C.tobytes(), t.tobytes()])
    return codes, lens, tree

