"""Device Huffman entropy stage, decode side (counterpart of
sz3_tpu/ops/entropy_decode.py).

The reference decodes its MSB-first Huffman stream with one sequential walk
(HuffmanEncoder.hpp:225-279), and the stream has no chunk markers. The device
decode splits it into fixed 1024-bit windows that decode speculatively, all
at once:

  scan_windows     csrc/huff_scan.cu, replaces _scan_kernel (K4). A window
                   starts 64 bits early (its runway, inside the window
                   before). Huffman codes self-synchronise, so by its own
                   first bit the walk has almost surely met the true symbol
                   boundaries. Each window records its entry (first boundary
                   at or after its start), its exit (first boundary at or
                   after its end), how many symbols started in the runway
                   (nskip) and in the window (nout), and the symbols.
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
  compact_windows  csrc/huff_compact.cu, replaces _compact_kernel (K5): each
                   window's owned run syms[w, nskip : nskip + nout] to its
                   exclusive prefix offset in the dense stream.

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

W_BITS = 1024                       # window payload bits
RUN_BITS = 64                       # runway: the early start that lets a window synchronise
L1_BITS = 11                        # direct table width
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
    cap: int                        # symbols a window can decode: row length of `syms`


class ScanState(NamedTuple):
    """Per-window results of the scan, updated in place by each pass."""
    syms: torch.Tensor              # (nwin, cap) int32: decoded symbols, runway first
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

    l1_sym = np.zeros(1 << L1_BITS, np.int32)
    l1_len = np.zeros(1 << L1_BITS, np.int32)
    short = L <= L1_BITS
    for c, ln, sy in zip(C[short].tolist(), L[short].tolist(), syms[short].tolist()):
        lo = c << (L1_BITS - ln)
        l1_sym[lo:lo + (1 << (L1_BITS - ln))] = sy
        l1_len[lo:lo + (1 << (L1_BITS - ln))] = ln
    deep = ~short
    left = C[deep] << (MAXLEN - L[deep]).astype(np.uint64)
    order = np.argsort(left, kind="stable")
    key = (left[order] ^ np.uint64(1 << 63)).view(np.int64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DecodeTables(dev(l1_sym), dev(l1_len), dev(key),
                        dev(syms[deep][order].astype(np.int32)),
                        dev(L[deep][order].astype(np.int32)), cap)


def new_scan_state(nwin: int, cap: int, device) -> ScanState:
    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    return ScanState(i32(nwin, cap), i32(nwin), i32(nwin), i32(nwin), i32(nwin))


def _check_scan(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                idx: torch.Tensor, starts: torch.Tensor, state: ScanState) -> None:
    dev = stream.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if stream.dtype != torch.uint8 or stream.dim() != 1 or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous 1-D uint8 tensor")
    if stream.numel() % 4 or stream.numel() * 8 < total_bits + 8 * PAD_BYTES:
        raise ValueError("stream must hold total_bits, then PAD_BYTES zero bytes, and a "
                         "whole number of 32-bit words")
    nwin = state.entry.numel()
    if nwin != max(1, -(-total_bits // W_BITS)) or state.syms.shape != (nwin, tables.cap):
        raise ValueError("scan state does not fit the stream")
    for t, dt in ((idx, torch.int32), (starts, torch.int32), *((s, torch.int32) for s in state),
                  (tables.l1_sym, torch.int32), (tables.l1_len, torch.int32),
                  (tables.deep_key, torch.int64), (tables.deep_sym, torch.int32),
                  (tables.deep_len, torch.int32)):
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


def _walk_plain(stream: torch.Tensor, total_bits: int, tables: DecodeTables,
                idx: torch.Tensor, starts: torch.Tensor, state: ScanState) -> None:
    n = idx.numel()
    dev = stream.device
    b = stream.view(-1, 4).to(torch.int64)
    words = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
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
    syms = state.syms[w]                               # the rest of a row stays as it was
    l1_sym, l1_len = tables.l1_sym.to(torch.int64), tables.l1_len.to(torch.int64)
    deep_sym, deep_len = tables.deep_sym.to(torch.int64), tables.deep_len.to(torch.int64)
    ndeep = tables.deep_key.numel()
    last_word = words.numel() - 3
    for step in range(tables.cap):
        if bool(done.all()):
            break
        active = ~done
        p = base + pos
        wi = (p >> 5).clamp(min=0, max=last_word)
        sh = p & 31
        w0, w1, w2 = words[wi], words[wi + 1], words[wi + 2]
        hi = ((w0 << sh) | (w1 >> (32 - sh))) & 0xFFFFFFFF
        lo = ((w1 << sh) | (w2 >> (32 - sh))) & 0xFFFFFFFF
        i1 = hi >> (32 - L1_BITS)
        ln = l1_len[i1]
        sym = l1_sym[i1]
        if ndeep:
            key = ((hi << 32) | lo) ^ _MIN64
            r = torch.searchsorted(tables.deep_key, key, right=True) - 1
            is_deep = ln == 0
            sym = torch.where(is_deep, deep_sym[r.clamp(min=0)], sym)
            ln = torch.where(is_deep, torch.where(r >= 0, deep_len[r.clamp(min=0)], 0), ln)
        valid = active & (ln > 0)                      # ln == 0: these bits are no code
        syms[:, step] = torch.where(valid, sym.to(torch.int32), syms[:, step])
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
    state.syms[w] = syms
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
    total_bits)), its runway the 64 bits before. Writes each window's row of
    `state` in place: entry = first symbol boundary >= RUN_BITS, exit = first
    boundary >= the window's end, nskip = symbols that started in the runway,
    nout = symbols that started in the window, and all nskip + nout symbols
    at syms[w, :] (the rest of the row is left as it was). A window whose
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
    cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
    if chain:
        listed = torch.zeros(state.entry.numel(), dtype=torch.uint8, device=stream.device)
        listed[idx.to(torch.int64)] = 1
    rc = kernels().szt_huff_scan(
        stream.data_ptr(), stream.numel() // 4, total_bits, n, state.entry.numel(),
        listed.data_ptr() if chain else None, idx.data_ptr(), starts.data_ptr(),
        tables.l1_sym.data_ptr(), tables.l1_len.data_ptr(), tables.deep_key.data_ptr(),
        tables.deep_key.numel(), tables.deep_sym.data_ptr(), tables.deep_len.data_ptr(),
        tables.cap, state.syms.data_ptr(), state.entry.data_ptr(), state.exit.data_ptr(),
        state.nskip.data_ptr(), state.nout.data_ptr(), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"szt_huff_scan: CUDA error {rc}")
    scan_windows.launches += 1
    return None


scan_windows.launches = 0


# ---- K5: compaction of the windows' owned runs -----------------------------------

def _check_compact(syms, nskip, nout, off, count):
    nwin = nskip.numel()
    dev = syms.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if syms.dim() != 2 or syms.shape[0] != nwin or nout.shape != (nwin,) or off.shape != (nwin,):
        raise ValueError("syms must be (nwin, cap), and nskip, nout, off (nwin,)")
    for t, dt in ((syms, torch.int32), (nskip, torch.int32), (nout, torch.int32),
                  (off, torch.int64)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError("syms, nskip, nout must be contiguous int32 and off int64, "
                             "on one device")
    if not 0 < count < 2 ** 40:
        raise ValueError(f"count {count} outside (0, 2^40)")


def compact_plain(syms: torch.Tensor, nskip: torch.Tensor, nout: torch.Tensor,
                  off: torch.Tensor, count: int) -> torch.Tensor:
    """Plain version of :func:`compact_windows`."""
    nwin, cap = syms.shape
    n64 = nout.to(torch.int64)
    w = torch.repeat_interleave(torch.arange(nwin, device=syms.device), n64)
    j = torch.arange(w.numel(), device=syms.device) - (torch.cumsum(n64, 0) - n64)[w]
    dense = torch.zeros(count, dtype=torch.int32, device=syms.device)
    dense[off[w] + j] = syms.reshape(-1)[w * cap + nskip.to(torch.int64)[w] + j]
    return dense


def compact_windows(syms: torch.Tensor, nskip: torch.Tensor, nout: torch.Tensor,
                    off: torch.Tensor, count: int) -> torch.Tensor:
    """Per-window symbol rows -> the dense stream (count,) int32:
    dense[off[w] : off[w] + nout[w]] = syms[w, nskip[w] : nskip[w] + nout[w]].
    The caller gives runs that tile [0, count) (off the exclusive scan of
    nout, summing to count) and lie inside their rows."""
    _check_compact(syms, nskip, nout, off, count)
    if syms.device.type == "cpu":
        return compact_plain(syms, nskip, nout, off, count)
    dense = torch.empty(count, dtype=torch.int32, device=syms.device)
    cuda_stream = torch.cuda.current_stream(syms.device).cuda_stream
    rc = kernels().szt_huff_compact(syms.data_ptr(), syms.shape[1], syms.shape[0],
                                    nskip.data_ptr(), nout.data_ptr(), off.data_ptr(),
                                    dense.data_ptr(), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"szt_huff_compact: CUDA error {rc}")
    compact_windows.launches += 1
    return dense


compact_windows.launches = 0


# ---- orchestration -----------------------------------------------------------------

def upload_bytes(data, device, pad: int = 0) -> torch.Tensor:
    """A read-only host buffer -> uint8 tensor on `device`, followed by `pad`
    zero bytes and rounded up to a whole number of 32-bit words."""
    data = memoryview(data).cast("B")
    n = len(data)
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
    row's range is a valid speculation, and the first bad window's is the
    proven one."""
    idx = torch.nonzero(bad).reshape(-1)
    starts = (want[idx] - wstart[idx] + RUN_BITS).clamp(0, RUN_BITS + W_BITS + MAXLEN - 1)
    return idx.to(torch.int32), starts.to(torch.int32)


def owned_runs(state: ScanState, count: int):
    """(nout, off) of the compaction: the windows' owned counts, the last one
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
    state = new_scan_state(nwin, tables.cap, device)
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
    return compact_windows(state.syms, state.nskip, nout, off, count)
