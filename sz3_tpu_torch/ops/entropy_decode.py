"""Device Huffman entropy stage, decode side (counterpart of
sz3_tpu/ops/entropy_decode.py).

The reference decodes its MSB-first Huffman stream with one sequential walk
(HuffmanEncoder.hpp:225-279), and the stream has no chunk markers. The device
decode splits it into fixed 1024-bit windows that decode speculatively, all
at once, and decodes every window twice: once to count, once to write.

  scan_windows     csrc/huff_scan.cu, replaces _scan_kernel (K4): the count
                   phase. A window starts RUN_BITS bits early (its runway,
                   inside the window before). Huffman codes
                   self-synchronise, so by its own first bit the walk has
                   almost surely met the true symbol boundaries. Each window
                   records its entry (first boundary at or after its start),
                   its exit (first boundary at or after its end), and how
                   many symbols started in the runway (nskip) and in the
                   window (nout). No symbol is stored.
  validation       exit[i] == entry[i+1] for every i, with window 0 pinned
                   to bit 0, proves by induction that every window decoded
                   the true sequence; synchronisation is no part of the
                   argument. The chain is checked on the device and the host
                   reads the number of bad windows. Bad windows are scanned
                   again from the exit of the window before, as chains: a
                   walk goes on into the next window while that is bad too
                   or does not start where the walk ended. The first bad
                   window's entry is proven, so every pass extends the
                   proven prefix and the loop ends.
  write_windows    csrc/huff_write.cu, replaces _compact_kernel (K5): the
                   write phase. Each window is walked again from its proven
                   entry for exactly its nout symbols, which go straight to
                   its exclusive prefix offset in the dense stream. The TPU
                   package copies them out of per-window symbol rows
                   instead; no such rows exist here.

Symbol lookup: an 11-bit direct table resolves the short codes; a longer
code is the predecessor of the next 64 stream bits among the sorted
left-aligned deep codewords (a prefix-free code's left-aligned codewords
partition the 64-bit space), found by binary search. Codes of up to 64 bits
decode, which is every code the port's encode writes.

Each wrapper runs its plain PyTorch version when handed a CPU tensor, and
only then. For a CUDA tensor it launches the kernel or raises. ``launches``
on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..build import kernels
from ..utils import trace

W_BITS = 1024                       # window payload bits
RUN_BITS = 128                      # runway: the early start that lets a window synchronise,
                                    # a multiple of 32 up to 256 (the JAX package's is 64,
                                    # which leaves four times as many windows to the rescans)
L1_BITS = 11                        # direct table width
SUB_BITS = 13                       # a second table resolves a prefix's longer codes by up to
                                    # this many more bits: codes of up to 24 bits in two loads
SUB_BUDGET = 1 << 20                # entries of all second tables together
MAXLEN = 64                         # longest code the decode takes
PAD_BYTES = 16                      # zero bytes after the stream: the last window's peeks

_MIN64 = -2 ** 63


class DecodeTables(NamedTuple):
    """Lookup structures of one Huffman code, on the decode's device."""
    l1_sym: torch.Tensor            # (2048,) int32: symbol of the short code under a prefix
    l1_len: torch.Tensor            # (2048,) int32: its length; 0 = a deep code starts here
    deep_key: torch.Tensor          # (ndeep,) int64: left-aligned deep codewords, sorted,
                                    # in the signed-compare domain (bits ^ 2^63)
    deep_sym: torch.Tensor          # (ndeep,) int32
    deep_len: torch.Tensor          # (ndeep,) int32
    # what the kernels look codes up in (csrc/huff_walk.cuh, CodeTables); the plain
    # versions use the five tensors above
    root: torch.Tensor              # (2048,) int32 by 11-bit prefix. Low byte: a short code's
                                    # length, or 0x80 | m where a second table resolves the
                                    # prefix's longer codes by their next m bits, or 0 (search
                                    # the deep codes). Upper 24 bits: the second table's
                                    # offset; for a short code, the bits (byte 1) and number
                                    # (byte 2) of the short codes that lie whole in the 11 bits
    sub_len: torch.Tensor           # (nsub,) uint8: the second tables' code lengths; 0 sends
                                    # the lookup on to the search
    sub_sym: torch.Tensor           # (nsub,) int32: their symbols
    maxlen: int                     # the longest code
    cap: int                        # the most symbols a window's walk takes


class ScanState(NamedTuple):
    """Per-window results of the scan, updated in place by each pass."""
    entry: torch.Tensor             # (nwin,) int32, runway-relative bit
    exit: torch.Tensor              # (nwin,) int32, runway-relative bit; -1 = walk not ended
    nskip: torch.Tensor             # (nwin,) int32
    nout: torch.Tensor              # (nwin,) int32


def build_decode_tables(codes: np.ndarray, lens: np.ndarray, offset: int,
                        device) -> DecodeTables:
    """Exported (code, len) table, indexed by symbol - offset with right-aligned
    codes, -> the lookup structures on `device`."""
    lens = np.asarray(lens).astype(np.int64)
    present = np.flatnonzero(lens > 0)
    if present.size < 2:
        raise ValueError("a Huffman code needs at least two symbols")
    L = lens[present]
    C = np.asarray(codes).astype(np.uint64)[present]
    syms = present + offset
    if int(L.max()) > MAXLEN:
        raise ValueError(f"huffman code length {int(L.max())} > {MAXLEN}")
    if not (np.iinfo(np.int32).min <= syms.min() and syms.max() <= np.iinfo(np.int32).max):
        raise ValueError("huffman symbols outside int32")
    cap = (RUN_BITS + W_BITS) // int(L.min()) + 2

    short = L <= L1_BITS
    by_code = np.argsort(C[short] << (L1_BITS - L[short]).astype(np.uint64))
    sl, ss = L[short][by_code], syms[short][by_code]
    l1_sym, l1_len = _tile(1 << L1_BITS,
                           (C[short][by_code] << (L1_BITS - sl).astype(np.uint64)).astype(np.int64),
                           np.int64(1) << (L1_BITS - sl), ss.astype(np.int32), sl.astype(np.int32))
    deep = ~short
    left = C[deep] << (MAXLEN - L[deep]).astype(np.uint64)
    order = np.argsort(left)                           # a prefix-free code: no two are equal
    key = (left[order] ^ np.uint64(1 << 63)).view(np.int64)

    root, sub_len, sub_sym = _second_tables(left[order], L[deep][order], syms[deep][order])
    root |= _short_groups(l1_len)
    # one upload for the int32 tables (each small copy from pageable memory
    # costs more than its bytes)
    i32 = [l1_sym, l1_len, syms[deep][order], L[deep][order], root, sub_sym]
    joined = torch.from_numpy(np.concatenate(i32).astype(np.int32, copy=False)).to(device)
    t_sym, t_len, d_sym, d_len, t_root, s_sym = torch.split(joined, [a.size for a in i32])
    return DecodeTables(t_sym, t_len, torch.from_numpy(np.ascontiguousarray(key)).to(device),
                        d_sym, d_len, t_root, torch.from_numpy(sub_len).to(device), s_sym,
                        int(L.max()), cap)


def _short_groups(l1_len: np.ndarray) -> np.ndarray:
    """Root entries of the short codes, by 11-bit prefix: the first code's
    length (low byte), and the bits (byte 1) and number (byte 2) of all the
    short codes that lie whole within the 11 bits, the first included."""
    prefix = np.arange(1 << L1_BITS)
    bits = np.zeros(1 << L1_BITS, np.int32)
    number = np.zeros(1 << L1_BITS, np.int32)
    going = np.ones(1 << L1_BITS, bool)
    shortest = int(l1_len[l1_len > 0].min()) if l1_len.any() else L1_BITS
    for _ in range(L1_BITS // shortest):                # no more codes than that fit in 11 bits
        ln = l1_len[(prefix << bits) & ((1 << L1_BITS) - 1)]
        going &= (ln > 0) & (bits + ln <= L1_BITS)
        bits += np.where(going, ln, 0)
        number += going
    return np.where(l1_len > 0, l1_len | (bits << 8) | (number << 16), 0).astype(np.int32)


def _tile(total: int, start: np.ndarray, span: np.ndarray, *values: np.ndarray):
    """For each array of `values`, an array of `total` entries that holds
    values[i] at [start[i], start[i] + span[i]) and 0 elsewhere. The intervals
    ascend and do not overlap."""
    n = start.size
    counts = np.empty(2 * n + 1, np.int64)              # gap, interval, gap, ..., gap
    ends = start + span
    counts[0:2 * n:2] = start - np.concatenate([[0], ends[:-1]])
    counts[1:2 * n:2] = span
    counts[2 * n] = total - (ends[-1] if n else 0)
    out = []
    for v in values:
        seq = np.zeros(2 * n + 1, v.dtype)
        seq[1:2 * n:2] = v
        out.append(np.repeat(seq, counts))
    return out


def _second_tables(left: np.ndarray, lens: np.ndarray, syms: np.ndarray):
    """The deep codes (left-aligned codewords ascending, uint64) -> (root
    entries of their 11-bit prefixes, sub_len, sub_sym). Each prefix gets a
    table indexed by the next m bits, m = min(its longest code - 11,
    SUB_BITS), in ascending order of prefix for as long as SUB_BUDGET entries
    last. A code fills every entry its bits lead to; entries of longer codes
    stay 0."""
    root = np.zeros(1 << L1_BITS, np.int32)
    if left.size == 0:
        return root, np.zeros(0, np.uint8), np.zeros(0, np.int32)
    prefix = (left >> np.uint64(64 - L1_BITS)).astype(np.int64)
    first = np.flatnonzero(np.r_[True, prefix[1:] != prefix[:-1]])   # ascending: group starts
    m = np.minimum(np.maximum.reduceat(lens, first) - L1_BITS, SUB_BITS)
    size = np.int64(1) << m
    off = np.cumsum(size) - size
    take = off + size <= SUB_BUDGET
    root[prefix[first][take]] = ((off[take] << 8) | 0x80 | m[take]).astype(np.int32)
    per = np.diff(np.r_[first, left.size])              # codes of each group
    width = L1_BITS + np.repeat(m, per)
    fits = np.repeat(take, per) & (lens <= width)
    width, cl = width[fits], lens[fits]
    start = np.repeat(off, per)[fits] + (
        (left[fits] >> (64 - width).astype(np.uint64)).astype(np.int64)
        & ((np.int64(1) << (width - L1_BITS)) - 1))
    sub_len, sub_sym = _tile(int((size * take).sum()), start, np.int64(1) << (width - cl),
                             cl.astype(np.uint8), syms[fits].astype(np.int32))
    return root, sub_len, sub_sym


def new_scan_state(nwin: int, device) -> ScanState:
    return ScanState(*(torch.empty(nwin, dtype=torch.int32, device=device) for _ in range(4)))


def _table_tensors(tables: DecodeTables):
    return ((tables.l1_sym, torch.int32), (tables.l1_len, torch.int32),
            (tables.deep_key, torch.int64), (tables.deep_sym, torch.int32),
            (tables.deep_len, torch.int32), (tables.root, torch.int32),
            (tables.sub_len, torch.uint8), (tables.sub_sym, torch.int32))


def _check_stream(stream: torch.Tensor, total_bits: int) -> None:
    if stream.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {stream.device}")
    if stream.dtype != torch.uint8 or stream.dim() != 1 or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous 1-D uint8 tensor")
    if (stream.numel() % 4 or stream.numel() * 8 < total_bits + 8 * PAD_BYTES
            or stream.data_ptr() % 4):
        raise ValueError("stream must hold total_bits, then PAD_BYTES zero bytes, and a "
                         "whole number of aligned 32-bit words")


def _check_scan(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                idx: torch.Tensor, starts: torch.Tensor, state: ScanState) -> None:
    _check_stream(stream, total_bits)
    dev = stream.device
    nwin = state.entry.numel()
    if nwin != max(1, -(-total_bits // W_BITS)) or any(s.shape != (nwin,) for s in state):
        raise ValueError("scan state does not fit the stream")
    for t, dt in ((idx, torch.int32), (starts, torch.int32), *((s, torch.int32) for s in state),
                  *_table_tensors(tables)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError("scan arguments must be contiguous tensors of their documented "
                             "types on the stream's device")
    if idx.shape != starts.shape or idx.dim() != 1:
        raise ValueError("idx and starts must be 1-D and of one length")


# ---- K4: speculative window scan -------------------------------------------------

def scan_windows_plain(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                       idx: torch.Tensor, starts: torch.Tensor, state: ScanState,
                       chain: bool = False) -> None:
    """Plain version of :func:`scan_windows`: all windows of `idx` step one
    symbol at a time; chained, the k-th windows of all walks do, for k = 0, 1, ..."""
    if idx.numel() == 0:
        return None
    if not chain:
        return _walk_plain(stream, total_bits, tables, idx, starts, state)
    nwin = state.entry.numel()
    w = idx.to(torch.int64)
    listed = torch.zeros(nwin + 1, dtype=torch.bool, device=idx.device)
    listed[w] = True
    start_of = torch.zeros(nwin + 1, dtype=torch.int32, device=idx.device)
    start_of[w] = starts
    head = ~listed[w - 1] | (w == 0)                   # its predecessor is not listed
    cur, s = w[head], starts[head]
    while cur.numel():
        _walk_plain(stream, total_bits, tables, cur.to(torch.int32), s, state)
        ex = state.exit[cur]
        nxt = cur + 1
        inside = nxt < nwin
        nxt_c = nxt.clamp(max=nwin - 1)
        open_ = (ex >= 0) & (ex - W_BITS != state.entry[nxt_c])
        # a listed window after an unlisted one starts another walk
        go = inside & torch.where(listed[nxt], listed[cur], open_)
        s = torch.where(ex >= 0, ex - W_BITS, start_of[nxt])[go]
        cur = nxt[go]
    return None


def _be_words(stream: torch.Tensor) -> torch.Tensor:
    """The stream's big-endian 32-bit words, as int64."""
    b = stream.view(-1, 4).to(torch.int64)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def _lookup_plain(words: torch.Tensor, p: torch.Tensor, tables: DecodeTables):
    """(symbol, length) of the code at each absolute stream bit of `p`, int64;
    length 0 where the bits there are no code."""
    wi = (p >> 5).clamp(min=0, max=words.numel() - 3)
    sh = p & 31
    w0, w1, w2 = words[wi], words[wi + 1], words[wi + 2]
    hi = ((w0 << sh) | (w1 >> (32 - sh))) & 0xFFFFFFFF
    lo = ((w1 << sh) | (w2 >> (32 - sh))) & 0xFFFFFFFF
    i1 = hi >> (32 - L1_BITS)
    ln = tables.l1_len[i1].to(torch.int64)
    sym = tables.l1_sym[i1].to(torch.int64)
    if tables.deep_key.numel():
        key = ((hi << 32) | lo) ^ _MIN64
        r = torch.searchsorted(tables.deep_key, key, right=True) - 1
        is_deep = ln == 0
        at = r.clamp(min=0)
        sym = torch.where(is_deep, tables.deep_sym[at].to(torch.int64), sym)
        ln = torch.where(is_deep, torch.where(r >= 0, tables.deep_len[at].to(torch.int64), 0),
                         ln)
    return sym, ln.clamp(min=0)


def _walk_plain(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                idx: torch.Tensor, starts: torch.Tensor, state: ScanState) -> None:
    n = idx.numel()
    dev = stream.device
    words = _be_words(stream)
    w = idx.to(torch.int64)
    base = w * W_BITS - RUN_BITS                       # absolute bit of the runway's start
    end = torch.clamp(total_bits - w * W_BITS, max=W_BITS) + RUN_BITS
    pos = starts.to(torch.int64)
    pos = torch.where(w == 0, pos.clamp(min=RUN_BITS), pos)
    done = pos >= end
    entry = torch.where(done, pos, -1)
    exit_ = entry.clone()
    nskip = torch.zeros(n, dtype=torch.int64, device=dev)
    nout = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tables.cap):
        if bool(done.all()):
            break
        active = ~done
        _, ln = _lookup_plain(words, base + pos, tables)
        valid = active & (ln > 0)                      # ln == 0: these bits are no code
        newpos = pos + ln
        pre = pos < RUN_BITS
        nskip += (valid & pre).to(torch.int64)
        nout += (valid & ~pre).to(torch.int64)
        entry = torch.where(valid & (entry < 0),
                            torch.where(pre, torch.where(newpos >= RUN_BITS, newpos, -1), pos),
                            entry)
        crossed = valid & (newpos >= end)
        exit_ = torch.where(crossed, newpos, exit_)
        pos = torch.where(valid, newpos, pos)
        done = done | crossed | (active & ~valid)
    for dst, src in ((state.entry, entry), (state.exit, exit_), (state.nskip, nskip),
                     (state.nout, nout)):
        dst[w] = src.to(torch.int32)


def scan_windows(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                 idx: torch.Tensor, starts: torch.Tensor, state: ScanState,
                 chain: bool = False) -> None:
    """Decode the windows `idx` (int32 window numbers, each once) of the
    big-endian byte stream `stream` (uint8; total_bits of stream, then at
    least PAD_BYTES zero bytes), window idx[i] from the runway-relative bit
    starts[i] (int32): 0 speculates from the runway's start, RUN_BITS or more
    is a known entry. Window w covers stream bits [1024 w, min(1024 (w + 1),
    total_bits)), its runway the RUN_BITS bits before. Writes each window's
    entries of `state` in place: entry = first symbol boundary >= RUN_BITS,
    exit = first boundary >= the window's end (-1 when the walk meets bits
    that are no code), nskip = symbols that started in the runway, nout =
    symbols that started in the window. No symbol is stored. A window whose
    start is at or past its end is done at once with entry = exit = start and
    no symbols. Window 0 has no runway and starts at RUN_BITS at the
    earliest. With `chain`, idx ascends and a walk goes on from its window
    into the next one, from its fresh exit: through a run of consecutive
    listed windows (whose own starts[i] serve only after a walk that did not
    end), and on into unlisted windows for as long as the exit is not the
    entry they recorded. So one rescan closes the chain behind every listed
    window up to the next listed one."""
    _check_scan(stream, total_bits, tables, idx, starts, state)
    if stream.device.type == "cpu":
        return scan_windows_plain(stream, total_bits, tables, idx, starts, state, chain)
    n = idx.numel()
    if n == 0:
        return None
    rc = kernels().szt_huff_scan(
        stream.data_ptr(), stream.numel() // 4, total_bits, n, state.entry.numel(), int(chain),
        RUN_BITS, idx.data_ptr(), starts.data_ptr(), tables.root.data_ptr(),
        tables.sub_len.data_ptr(), tables.deep_key.data_ptr(), tables.deep_key.numel(), tables.deep_len.data_ptr(),
        int(tables.maxlen > 32), state.entry.data_ptr(), state.exit.data_ptr(),
        state.nskip.data_ptr(), state.nout.data_ptr(),
        torch.cuda.current_stream(stream.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"szt_huff_scan: CUDA error {rc}")
    scan_windows.launches += 1
    return None


scan_windows.launches = 0


# ---- K5's function: the write phase ------------------------------------------------

def _check_write(stream, total_bits, tables, entry, nout, off, count):
    _check_stream(stream, total_bits)
    dev = stream.device
    nwin = max(1, -(-total_bits // W_BITS))
    for t, dt in ((entry, torch.int32), (nout, torch.int32), (off, torch.int64)):
        if t.shape != (nwin,) or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError("entry, nout (int32) and off (int64) must be contiguous, one entry "
                             "per window, on the stream's device")
    for t, dt in _table_tensors(tables):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError("decode tables must be contiguous tensors on the stream's device")
    if not 0 < count < 2 ** 40:
        raise ValueError(f"count {count} outside (0, 2^40)")


def write_windows_plain(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                        entry: torch.Tensor, nout: torch.Tensor, off: torch.Tensor,
                        count: int) -> torch.Tensor:
    """Plain version of :func:`write_windows`: all windows step one symbol at
    a time, each until it has written its count."""
    words = _be_words(stream)
    nwin = entry.numel()
    w = torch.arange(nwin, dtype=torch.int64, device=stream.device)
    pos = (w * W_BITS + entry - RUN_BITS).clamp(min=0)
    n = torch.minimum(nout.to(torch.int64), count - off)
    n = torch.where((off < 0) | (off >= count), 0, n)
    dense = torch.zeros(count, dtype=torch.int32, device=stream.device)
    live = torch.nonzero(n > 0).reshape(-1)
    j = 0
    while live.numel():
        sym, ln = _lookup_plain(words, pos[live], tables)
        dense[off[live] + j] = torch.where(ln > 0, sym, 0).to(torch.int32)
        pos[live] += ln
        j += 1
        live = live[n[live] > j]
    return dense


def write_windows(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                  entry: torch.Tensor, nout: torch.Tensor, off: torch.Tensor,
                  count: int) -> torch.Tensor:
    """The windows' owned symbols -> the dense stream (count,) int32:
    dense[off[w] + j] = the j-th symbol decoded from the stream bit
    1024 w + entry[w] - RUN_BITS on, for j < nout[w]. `entry` is what
    scan_windows recorded. The counts end the walks, not the stream's end:
    the caller gives runs that tile [0, count) (off the exclusive scan of
    nout, summing to count). A run is cut at `count`; bits that are no code
    give symbol 0."""
    _check_write(stream, total_bits, tables, entry, nout, off, count)
    if stream.device.type == "cpu":
        return write_windows_plain(stream, total_bits, tables, entry, nout, off, count)
    dense = torch.empty(count, dtype=torch.int32, device=stream.device)
    rc = kernels().szt_huff_write(
        stream.data_ptr(), stream.numel() // 4, entry.numel(), RUN_BITS, entry.data_ptr(),
        nout.data_ptr(), off.data_ptr(), count, int(tables.maxlen > 32),
        tables.root.data_ptr(), tables.l1_sym.data_ptr(), tables.sub_len.data_ptr(),
        tables.sub_sym.data_ptr(), tables.deep_key.data_ptr(), tables.deep_key.numel(),
        tables.deep_sym.data_ptr(), tables.deep_len.data_ptr(), dense.data_ptr(),
        torch.cuda.current_stream(stream.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"szt_huff_write: CUDA error {rc}")
    write_windows.launches += 1
    return dense


write_windows.launches = 0


# ---- orchestration -----------------------------------------------------------------

def upload_bytes(data, device, pad: int = 0) -> torch.Tensor:
    """A read-only host buffer -> uint8 tensor on `device`, followed by `pad`
    zero bytes and rounded up to a whole number of 32-bit words."""
    data = memoryview(data).cast("B")
    n = len(data)
    with trace.span("copy.h2d", bytes=n, pinned=False):
        out = torch.zeros(-(-(n + pad) // 4) * 4, dtype=torch.uint8, device=device)
        if n:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)   # the buffer is only read
                src = torch.frombuffer(data, dtype=torch.uint8)
            out[:n].copy_(src)
    return out


def bad_windows(state: ScanState, wstart: torch.Tensor):
    """Chain validation on the device: (mask of the windows whose entry is not
    the exit of the window before, or whose walk did not end; the entry each
    window should have had, as an absolute bit). Window 0 is pinned to bit 0."""
    exit_abs = wstart + state.exit - RUN_BITS
    entry_abs = wstart + state.entry - RUN_BITS
    want = torch.cat([torch.zeros(1, dtype=torch.int64, device=wstart.device), exit_abs[:-1]])
    return (want != entry_abs) | (state.exit < 0), want


def rescan_args(bad: torch.Tensor, want: torch.Tensor, wstart: torch.Tensor):
    """(idx, starts) of the rescan of the bad windows, each from the exit of
    the window before. A stale exit may point anywhere; any start in the
    window's range is a valid speculation, and the first bad window's is the
    proven one."""
    idx = torch.nonzero(bad).reshape(-1)
    starts = (want[idx] - wstart[idx] + RUN_BITS).clamp(0, RUN_BITS + W_BITS + MAXLEN - 1)
    return idx.to(torch.int32), starts.to(torch.int32)


def owned_runs(state: ScanState, count: int):
    """(nout, off) of the write phase: the windows' owned counts, the last one
    less the spurious symbols that the zero bits padding the stream's last
    byte decode to, and their exclusive scan. Raises ValueError when the
    windows do not hold `count` symbols."""
    nout = state.nout.clone()
    excess = int(nout.sum(dtype=torch.int64)) - count
    if excess < 0 or excess > int(nout[-1]):
        raise ValueError(f"decoded symbol count {excess + count} != archived count {count}")
    nout[-1] -= excess
    n64 = nout.to(torch.int64)
    return nout, torch.cumsum(n64, 0) - n64


def decode_stream(bits, count: int, codes: np.ndarray, lens: np.ndarray, offset: int,
                  device, stats: Optional[dict] = None) -> torch.Tensor:
    """Huffman stream bytes -> the dense archive-order symbols, (count,) int32
    on `device`. `codes`/`lens` are the exported table (right-aligned codes
    of up to 64 bits, indexed by symbol - offset). Raises ValueError when the
    stream does not hold `count` symbols. `stats`, when given, receives the
    number of windows, of scan passes, and each pass's number of windows."""
    device = torch.device(device)
    total_bits = len(bits) * 8
    if count <= 0 or total_bits == 0:
        raise ValueError(f"empty stream ({count} symbols in {total_bits} bits)")
    tables = build_decode_tables(codes, lens, offset, device)
    stream = upload_bytes(bits, device, PAD_BYTES)
    nwin = -(-total_bits // W_BITS)
    state = new_scan_state(nwin, device)
    idx = torch.arange(nwin, dtype=torch.int32, device=device)
    starts = torch.zeros(nwin, dtype=torch.int32, device=device)
    starts[0] = RUN_BITS
    wstart = idx.to(torch.int64) * W_BITS
    redo = []
    while True:
        # a rescan walks each run of consecutive bad windows as one chain
        scan_windows(stream, total_bits, tables, idx, starts, state, chain=bool(redo))
        redo.append(idx.numel())
        bad, want = bad_windows(state, wstart)
        if int(bad.sum()) == 0:
            break
        if len(redo) > nwin:
            raise ValueError("huffman stream does not decode: a window walked from its "
                             "proven entry does not end")
        idx, starts = rescan_args(bad, want, wstart)
    if stats is not None:
        stats.update(nwin=nwin, passes=len(redo), redo_counts=redo, cap=tables.cap)
    nout, off = owned_runs(state, count)
    return write_windows(stream, total_bits, tables, state.entry, nout, off, count)
