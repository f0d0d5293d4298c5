#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``csnappy_tpu_torch``) on one H100.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phase GROUP   # one phase group alone, in this process

Builds the port's kernels from the sources in this checkout (phase 1), then
runs each phase group of ``GROUPS`` in a child process of its own,
``chip_smoke.py --phase GROUP``, one after another: decode (phases 2-5),
streams (6), container (7-9), movebench (10), primitives (11), probes
(12), kernel_lib (13), scaleout (14), hygiene (15), bench (16).  A fresh
process for each group keeps the profiler whole: in a process that has
lived beside other CUDA processes (phase 9's CLI, say) every session loses
its first records, more with each such process, until it loses every
trace (``tools/profiler_loss.py --sessions``).  Each child prints its
lines as it goes, then ``[phase] GROUP: S s, traces T, retaken R, lost L``
(the profiler traces it asked for, the sessions taken again, the traces
given up: ``timing.traces``) and one result line, ``{"phase_result": ...}``:
its ``kernels`` rows, the fields it puts on earlier groups' rows
(``annotate``) and the values the parent uses (``values``).  A child that
exits non-zero, outlives ``GROUP_LIMIT_S`` or prints no result line stops
the run: the parent prints its last ``TAIL`` characters and exits 1.  The
parent merges the rows (``merge``), prints the serial chains in
``walk_smem`` steps (``chain_lines``), the bench line's block decode beside
row 1, the ``[phase] total`` line, then phase 17.  Where a phase counts a
call's kernels from a trace, the wrappers' own launch counts of one more
call are printed beside it and must agree (``_agree``).  In order:

1. build   — every native source, one compiler each, all started together;
2. decode  — ``decode_blocks`` (``csrc/decode_blocks.cu``'s ``decode_kernel``
             for rows up to 32 KiB; past them ``csrc/decode_wide.cu``'s
             chain, segment and finish kernels, chosen by width) on B=64
             blocks of urls.10K (32 KiB each, as bench.py makes them) and on
             malformed and error-priority vectors at four output limits;
             ``decode_segments`` on urls.10K.snappy's body; every decode
             group of ``tests/data/torch_ref/blocks.npz`` (the adversarial
             ``dadv`` among them) equal to the JAX answers, but on the JAX
             package's known faults (``JAX_DECODE_FAULTS``), and the dadv
             rows' resolve rounds printed and bounded by ceil(log2
             block_out) + 1; 200 pages of 4 KiB; then the wide kernels: every
             group of ``wide.npz`` (65,536, 70,000, 2^18 and 2^20 B rows)
             equal to the oracle's stored answers and, but on the JAX
             faults, to the JAX answers; rows of 32,769, 65,536, 70,000,
             131,073, 2^18, 2^20 and 2^24 B (``wide_cases``: urls data, an
             offset-1 run, far COPY_4 reads, events in the first and the
             last segment) through ``decode_blocks`` and, read in place at
             mixed limits, ``decode_segments``; one ``decode_segments`` batch
             mixing widths; the main path's wide batch
             (``main_path_batch``) ``WIDE_REPEATS`` times, from host bytes
             and a card tensor in turn (``wide_repeats``), each call in a
             pool poisoned anew (``tools/hygiene.poison_pool``: every free
             block of the caching allocator filled with a byte that changes
             from call to call) and each output asserted to lie in the
             poison, so a byte no kernel writes reads wrong.  Each kernel
             result must equal the plain
             version run on CPU copies: every output byte, ``produced`` and
             ``status`` (exact: bytes have no tolerance);
3. encode  — ``encode_blocks`` (one kernel, ``csrc/encode_blocks.cu``) on the
             same B=64 x 32 KiB batch, equal byte for byte to the plain
             version (tensor-op preparation, plain walk), ``compress_np(urls.10K)``
             byte-identical to the JAX package's stream (the committed
             fixture, 354,567 B), the e1k, e4k and eadv groups of
             ``tests/data/torch_ref/blocks.npz`` equal to the JAX encoder's
             rows and to the plain version, and urls.10K as 4 KiB pages (as
             the container calls it) equal to the plain version;
4. main path — with every launch count set to 0, through the entry points a
             user calls (device=None, so the card): ``encode_blocks`` and
             ``decode_blocks`` on the B=64 batch from host arrays,
             ``api.compress(urls.10K)`` equal to the fixture,
             ``api.decompress(urls.10K.snappy)`` equal to urls.10K, a 32 KiB
             fragment and the unaligned vector round-trip, urls.10K.snappy's
             body as one ``decode_blocks`` row of 702,087 B and one
             ``decode_segments`` batch mixing widths; every kernel of the
             path must have launched, every narrow decode through
             ``decode_kernel`` and each wide call through the three wide
             kernels, each wrapper's and kernel's launches counted around
             each wide call (the ``kernels`` line's wide rows print those
             counts; rows 1-2 their calls through ``decode_kernel``); then ``torch.profiler`` counts the device
             kernels of one ``encode_blocks``, one ``decode_blocks`` and one
             ``decode_segments`` call on card tensors: exactly one each, the
             encoder's and ``decode_kernel``, and no sort, scan, gather or
             scatter; of one wide ``decode_blocks`` call one memset and the
             three wide kernels once each; of one
             ``decode_ws.decompress_noheader_ws`` call exactly two, the
             scan's and ``decode_kernel``;
5. times   — median of 20 CUDA-event-timed launches after warm-up for each
             kernel at the main path's shapes (inputs resident in L2), the
             plain version's time on the host, and the bound: the larger of
             the bytes the function must move over 3.35 TB/s and one
             operation per byte over 67 TOP/s (H100 SXM data sheet).  The
             serial chain (the longest block's tags over eight, the decoder's
             walk steps; for the encoder, twice the longest of its 32 walk
             segments' commits plus 32 steps) is counted and printed beside
             it; for the encoder and the decoder also the kernel alone
             (torch.profiler), a whole call and a lone call (host clock,
             synchronised), the shared memory at 32 KiB and 4 KiB and the SM
             cycles of their phases (``clock64()`` stamps, read by
             ``tools/phaseprof.py``); for the decoder
             its ``ptxas -v`` line; the wide kernels (``[wide]`` lines) at
             49,152, 65,536, 70,000 and 131,072 B, one row and 64 rows, and
             on urls.10K.snappy's and urls.10K x 24's bodies as one row of
             702,087 and 16,850,088 B: launch, kernels alone, a call, a lone
             call, each kernel's SM cycles by phase and the chains' spans
             (stamps), the bound, the plain version, and ``decode_stream.cu``
             on the same two bodies; their ``ptxas -v`` lines;
6. whole streams — on every stream of ``tests/data/torch_ref/streams.npz``
             and of ``scan_adv.npz`` (the adversarial scan group):
             ``scan_segments.cu`` equal to its plain walk at nslot = nseg + 1,
             2 and 1 and to the JAX scan (``seg``, ``meta[:3]``),
             ``decode_ws`` bytes-or-None equal to
             the JAX pipeline's, ``decode_stream.cu`` equal to its plain
             version at the exact limit, 5000 below it and at a multiple of
             32768, and to the JAX kernel, ``decode_jnp``'s torch ops on the
             card equal to the CPU and to the JAX decoder; then the main path
             of the slice with its launch counts set to 0: ``api.decompress``
             of urls.10K.snappy and of a 16 MiB stream (urls.10K x 24, compressed
             on the card) through ``decode_ws`` with no host scan, of the
             unaligned vector through ``decode_stream`` and of a COPY_4
             offset-40000 stream through ``decode_jnp``, and urls.10K.snappy
             once more with ``decode_ws`` answering None, through the host
             scan to one ``decode_segments`` launch and no ``decode_jnp``
             (a disagreeing segment decoder raises on the card); then times on the
             702 KB and 16 MiB streams (each kernel, the host scan, the whole
             ``decode_ws`` pipeline); for the scan also the kernel alone, its
             launch, a lone call, the SM cycles of the slowest block's phases
             and the chaining's span (``clock64()`` and ``%globaltimer``
             stamps), the sweep over its chunk sizes, ``decode_ws``'s device
             kernels a call, ``ptxas -v`` and shared memory, and a stream of
             the 16 MiB one's input length whose two tag chains never merge
             (exact, timed: the worst case); then ``decode_stream.cu`` (a
             chain grid over 8 KiB chunks and a grid of 32 KiB output
             segments) also on every stream of ``stream_adv.npz`` at its
             three limits against the plain version and the JAX kernel, and
             on four 16 MiB worst cases (urls.10K x 24, an offset-1 run of
             2^24 bytes, a 2^24-byte literal, 2^21 one-byte literals) at the
             three limits against the plain version; one call asserted with
             torch.profiler to run ``chain_kernel`` and ``segment_kernel``
             once each, at most one memset and no copy; then on
             urls.10K.snappy, the unaligned vector, the 16 MiB stream and
             the worst cases its kernels alone, launch, a call, a lone call,
             the SM cycles of both kernels' phases (stamps), the chains'
             spans a chunk and a segment (``%globaltimer``) and ``ptxas -v``;
7. container — ``tools/zramsim.run`` over a 256 MiB tree
             (``zramsim.corpus_tree``: the port's corpus files, urls.10K
             among them, copied under subdirectories up to 268,435,456 B) at 4 KiB pages on the card, with md5 readback of
             every file and the launch counts of ``encode_blocks`` and
             ``decode_blocks`` set to 0 before it; the first 64 pages of each
             corpus file equal to the plain versions' container; every
             stored page decoded by the port's host decoder
             (``native.decompress_noheader``) to its input page; the zram record
             on a JSON line of its own (``{"zram": ...}``): sizes, ratio, codec
             seconds and GB/s of compress and decompress, host seconds;
8. container fixture — the port's container on the card equal to the JAX
             fixture (``tests/data/torch_ref/container.npz``) byte for byte, with
             equal stats, and the malformed containers' error codes;
9. cli     — ``python -m csnappy_tpu_torch.cli`` in subprocesses on the card:
             ``file -c``/``-d`` of urls.10K, ``-d`` of urls.10K.snappy,
             ``-S c``/``-S d``, ``block -c``/``-d`` at 4 KiB; exit 0 and the
             right bytes;
10. movebench — rows 12-13 (the flat gather, ``lane_gather`` of
             ``csrc/primitives.cu`` with one row, and the one-pass max-scan
             of ``csrc/movebench.cu``): the ``ptxas -v`` lines of
             ``lane_gather_kernel``, ``lane_gather_staged_kernel`` and
             ``scan_kernel`` (no stack, no spill: asserted); both against
             their plain versions at n = 32768 and 2^24 with 0 differing
             elements, timed beside the kernel's own device time
             (``device_ms``, from torch.profiler), the library call
             (``tbl.view(-1)[idx]``, ``torch.cummax``) and the bound (12n and
             8n bytes over 3.35 TB/s), the device operations of one call
             asserted (one kernel; the scan one kernel and at most one
             memset); at 2^24 the gather's kernel also on sorted indices and
             on a 2^22-entry table (what its random reads cost); then
             ``movebench.main()`` with their launch counts set to 0, printing
             its five strategy lines;
11. primitives — rows 6-11 (``csrc/primitives.cu``: ``lane_gather``,
             ``scatter_or``, ``compose_round``, ``row_gather``): with their
             six launch counts set to 0, each wrapper of ``ops/primitives.py``
             once with device=None on the main path's batch (B=64 blocks of
             32 KiB as int32 [64, 256, 128];
             ``movebench.primitive_inputs``), every count moved; each result
             equal to the plain version on CPU copies and every case of
             ``tests/data/torch_ref/primitives.npz`` equal to the JAX Pallas
             kernels' answer (0 differing elements); times beside the
             kernel's own device time (``device_ms``), the plain version,
             the bound (bytes over 3.35 TB/s) and the library call where one
             PyTorch call computes the function (``torch.gather``,
             ``Tensor.scatter_reduce``, ``torch.index_select``,
             ``torch.take``, given in-range int64 indices; the wrapper and
             its library call timed in ``KL_ROUNDS`` interleaved rounds,
             medians), the device operations of one call asserted (one
             kernel) and the path
             ``lane_gather`` takes; both ``lane_gather`` kernels alone at the
             path rule's switch points (``LANE_GATHER_SWEEP``), equal to each
             other, beside the rule's pick; the host split of one
             ``table_gather`` and one ``scan_max`` call
             (``tools/torch_profile.primitive_host_split``);
12. probes — rows 14a-14i (``csrc/probe.cu``, ``csrc/probe3.cu``,
             ``csrc/probe4.cu``, ``tools/probe.py``): with every
             count of ``probe.launches`` set to 0, ``probe.measure`` of each
             kernel of ``probe.TIMED`` (probes that share an entry, as
             mosaic_probe6's four gathers do, once) and the capacity probe on
             the card (device=None): ns and SM cycles per iteration from the slope
             between k_lo and k_hi (CUDA events, and ``clock64()`` inside the
             kernel), its output at k_hi equal to the plain version, the
             shared-memory capacity in bytes by bisection; every count moved;
             then each probe at every K of ``tests/data/torch_ref/probes.npz``
             (and on its constructed inputs) equal to the JAX probes' answers
             and to the plain version (0 differing elements), and the
             resolve-phase gathers at ``probe.WRAP_K``, past the int32 wrap of
             their sum, equal to the plain version; one ``kernels`` row per
             ``pl.pallas_call`` site (nine) with its probes' times as a
             sub-list (``mosaic_probe6.taa_4096x128`` listed as failing to
             trace in JAX); then each serial chain of phases 5 and 6 in units
             of one measured ``walk_smem`` step (a dependent shared load and
             four integer operations: a yardstick, not a floor; printed only,
             never in the ``kernels`` line), and for ``decode_stream.cu`` its
             two chains' links (chunks chained, segments that waited on a
             flag) and their measured time a link;
13. kernel_lib — rows 15a-15b (``csrc/kernel_lib.cu`` over
             ``csrc/kernel_lib.cuh``, ``ops/kernel_lib.py``): with every count
             of ``kernel_lib.launches`` set to 0, each helper of
             ``kernel_lib.HELPERS`` on every case of
             ``tests/data/torch_ref/kernel_lib.npz`` on the card (device=None),
             equal to the JAX helpers' answers and to the plain version (0
             differing elements); every count moved; a call of each helper on
             its first case and the PyTorch call that computes the same
             function inside the contract, where there is one, timed in
             ``KL_ROUNDS`` interleaved rounds (median and spread), beside its
             kernel's own device time, the plain version and the bound
             (``kernel_lib.traffic``: what the helper reads on that case); one
             ``kernels`` row for each of the two ``pl.pallas_call`` sites with
             its helpers as a sub-list; ``scatter_rows_multi`` at the JAX
             fused kernels' three shapes (``MAIN_SCATTERS``: the fixture's
             ``srm_dec_co256``, ``srm_stream_co256_t3``, ``srm_enc_ocr304_t3``)
             timed the same way beside one ``index_add_`` over the stacked
             tables, and ``gather_rows_multi`` at its three (``MAIN_GATHERS``:
             ``grm_dec_ci256_t8``, ``grm_stream_r1664_t2``,
             ``grm_stream_r1664_t1``, then ``grm_r1664_clip`` with clipped
             indices) beside one ``index_select`` over the stacked tables,
             each case with its launches in the main-path run (asserted 1),
             its kernel alone and bound, and the harness's ``ptxas -v`` lines
             (``gather_harness``'s stack frame asserted 0 bytes); each shift
             and scan at its JAX call site's tile (``CALL_SITES``: the
             fixture's 12 cases of 256-2,048 rows, past what one block's
             shared memory holds) timed beside its PyTorch
             call where one computes it (``SITE_LIBRARY``: ``F.pad``,
             ``torch.cumsum``; none for ``fill_max_rows`` and the case
             outside the contract), with its kernels alone, its kernels a
             call (from a bracketed trace where it holds device records,
             asserted: one a shift, what the entry reports a scan), the
             bound and its launch in the main-path run; every shift and
             scan at each configuration of ``kernel_lib.SHIFT_SCAN_RUNS``
             on a (65,536, 128) tile of random int32 equal to its plain
             version (the scans' row rounds at all rounds as grid passes
             there); and the host
             split of one call of each scatter, of ``gather_rows_multi`` on
             ``grm_dec_ci256_t8`` and of ``lane_gather``, step by step;
14. scale-out — ``csnappy_tpu_torch/parallel`` over ``torch.distributed``:
             NCCL present (its version printed); a 1-rank NCCL group
             (``multihost.init``, 60 s timeout) on the card; with every
             launch count set to 0, ``mesh.compress_sharded(urls.10K)``
             byte-identical to the JAX fixture, ``decompress_fragments_sharded``
             of the oracle's 22 fragments joined to urls.10K, a fragment one
             byte over its own limit raising ``E_OUTPUT_OVERRUN``,
             ``multihost.compress_blocks_multihost`` offsets equal to the
             exclusive cumsum of its lengths, and the launch counts exact;
             ``torch.profiler``: one sharded compress runs ``encode_kernel``
             once and one sharded decompress ``decode_kernel`` once (every
             device operation printed, NCCL's by name); the median host ms of
             20 sharded calls beside ``api.compress`` and
             ``api.decompress_noheader`` on the same bytes (two readings each,
             in turns), their gap, and each all-gather alone; then the
             2-process ``--worker`` loopback on the one card over gloo (NCCL
             refuses two ranks on one card), byte-identical to one
             ``encode_blocks`` on the card, with its wall time and the time of
             the host copy gloo needs of a rank's lengths and rows;
             ``launches_sharded`` in rows 1-3 (row 1: ``decode_kernel``, the
             kernel rows 1 and 2 share; no wide kernel);
15. hygiene — ``python -m csnappy_tpu_torch.tools.hygiene --seed
             HYGIENE_SEED --seconds HYGIENE_SECONDS`` in a fresh process
             (the hygiene allocator of ``csrc/hygiene.cu`` replaces the
             caching allocator there before any CUDA allocation): every
             kernel of the port (``hygiene.KERNELS``) on seeded varied cases
             in memory poisoned with 0xA5 and with 0x5A between guard
             regions, the decoders, the scan and the look-back scan also
             behind the occupier kernel; its JSON lines printed; every
             kernel run in both poisons, no call differing from the plain
             version, no guard byte changed, no hang;
16. bench and records — ``bench_torch.main(["--reps", "5"])`` in this
             process: exactly one line with ``bench.py``'s 15 keys
             (``bench_torch.KEYS``), ``compressed_bytes`` 354,567, the card
             in ``device``, every rate above 0, ``roofline_utilization_pct``
             at most 100 (the parent prints it beside row 1's GB/s of phase
             5), then its block decode and row 1's launch timed in turns
             in this process (three rounds of row 1, bench, bench, row 1); then
             ``tools/records.main`` into a temporary directory: five
             non-empty files, the phaseprof rows (printed) over
             ``decode_fused.PHASES`` and ``encode_fused.PHASES`` with their
             ``delta_ms`` summing to the last ``cum_ms``, the benchtable's
             ``urls.10K`` row ``702087 ->   354567``, each record naming the
             card;
17. the ``kernels`` JSON line (rows 1-2's wide path as ``decode_blocks_wide``
   and ``decode_segments_wide`` after them), the card's name and power
   limit, and the result line.

Any failure raises and exits non-zero; with no card, or without the
package beside this script, it exits 2 before printing a result (a child
too).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
KL_ROUNDS = 5                   # phase 13's interleaved timing rounds
HYGIENE_SEED, HYGIENE_SECONDS = 20, 60    # phase 15's seed and budget
B, BS = 64, 32768             # the main path's batch: 64 blocks of 32 KiB


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _tags(frag: bytes) -> tuple[int, int]:
    """(tags, copies) of a valid headerless stream."""
    ip = tags = copies = 0
    while ip < len(frag):
        tag = frag[ip]
        kind = tag & 3
        tags += 1
        if kind == 0:
            u = tag >> 2
            nb = max(0, u - 59)
            ln = int.from_bytes(frag[ip + 1 : ip + 1 + nb], "little") + 1 if nb else u + 1
            ip += 1 + nb + ln
        else:
            copies += 1
            ip += (2, 3, 5)[kind - 1]
    return tags, copies


def _copy_starts(frag: bytes) -> list[int]:
    """Output positions of the copies of a valid headerless stream (the
    encoder's commits)."""
    ip = op = 0
    out = []
    while ip < len(frag):
        tag = frag[ip]
        kind = tag & 3
        if kind == 0:
            u = tag >> 2
            nb = max(0, u - 59)
            ln = int.from_bytes(frag[ip + 1 : ip + 1 + nb], "little") + 1 if nb else u + 1
            ip += 1 + nb + ln
            op += ln
        else:
            out.append(op)
            op += (((tag >> 2) & 7) + 4) if kind == 1 else (tag >> 2) + 1
            ip += (2, 3, 5)[kind - 1]
    return out


def _device_kernels(torch, fn, what: str) -> dict:
    """Device kernels (not copies or fills) of one ``fn()`` call on the card,
    by name, with their launch counts, from ``torch.profiler``, held
    against the wrappers' own counts (``_device_ops``)."""
    return {k: v for k, v in _device_ops(torch, fn, what).items()
            if not k.startswith(("Memcpy", "Memset"))}


def _device_ops(torch, fn, what: str) -> dict:
    """Every device operation (kernels, copies and fills) of one ``fn()``
    call on the card, by name, with its count a call, from
    ``torch.profiler``: ``tools/timing.device_profile`` over three calls,
    whose trace is taken again (up to ``timing.TRACE_TRIES`` times) until
    every operation was seen a whole number of times a call.  The wrappers'
    own counts of one more call are printed beside it and must agree
    (``_agree``)."""
    from csnappy_tpu_torch.tools.timing import device_profile

    ops = device_profile(fn, 3)["calls"]
    print(f"[counts] {what}: {_agree(what, ops, _wrapper_launches(torch, fn))[0]}", flush=True)
    return ops


def _counters() -> dict:
    """Every wrapper's launch count in this process, by counter: each
    decoder kernel of ``decode_fused.launches_by_kernel`` by its name, the
    encoder's, the scan's and the crossing-stream decoder's calls, each
    primitive's, each movebench wrapper's, each kernel_lib helper's."""
    from csnappy_tpu_torch.ops import (decode_fused, decode_stream, decode_ws, encode_fused,
                                       kernel_lib, primitives)
    from csnappy_tpu_torch.tools import movebench

    out = dict(decode_fused.launches_by_kernel)
    out.update({"encode_blocks": encode_fused.encode_blocks.launches,
                "scan_segments": decode_ws.scan_segments.launches,
                "decode_stream": decode_stream.decode_stream.launches})
    out.update({f"primitives.{fn}": p.wrapper.launches for fn, p in primitives.PRIMITIVES.items()})
    out.update({f"movebench.{w}": getattr(movebench, w).launches
                for w in ("gather_flat", "scan_max")})
    out.update({f"kernel_lib.{h}": n for h, n in kernel_lib.launches.items()})
    return out


# the kernels each count's launch runs, by name, where the count names them
NAMED_KERNELS = {"decode_kernel": ("decode_kernel",),
                 "wide_chain_kernel": ("wide_chain_kernel",),
                 "wide_segment_kernel": ("wide_segment_kernel",),
                 "wide_finish_kernel": ("wide_finish_kernel",),
                 "encode_blocks": ("encode_kernel",), "scan_segments": ("scan_kernel",),
                 "decode_stream": ("chain_kernel", "segment_kernel")}


def _wrapper_launches(torch, fn) -> dict:
    """The counts (``_counters``) one ``fn()`` call moves, without the profiler."""
    before = _counters()
    fn()
    torch.cuda.synchronize()
    return {k: n - before[k] for k, n in _counters().items() if n != before[k]}


def _kernel_name(op: str) -> str:
    """A trace's kernel record as the kernel's own name (no namespace,
    template arguments, return type or parameters)."""
    name = op.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return name[-1].split("::")[-1] if name else op


def _kernels_a_launch(counter: str) -> int:
    """Kernels one launch of a count whose kernels go by no fixed name runs:
    a kernel_lib scan what its entry reported on its last call, any other
    one."""
    from csnappy_tpu_torch.ops import kernel_lib as kl

    helper = counter.removeprefix("kernel_lib.")
    if helper != counter and kl.HELPERS[helper].kind == "scan":
        return kl.scan_kernels[helper]
    return 1


def _agree(what: str, ops: dict, moved: dict) -> str:
    """Hold a trace's count of one call's kernels (``ops``: operation ->
    count a call) against the wrappers' own counts of one call (``moved``):
    every kernel a count names (``NAMED_KERNELS``) seen as often as its
    wrappers launched it, and the kernels of the other counts as many as
    their launches run.  Kernels no wrapper launches (a library's, NCCL's)
    are not held.  A trace with no kernel record is not measured: the
    caller's own assertion decides.  Returns both counts as text and the
    kernels the wrappers launched."""
    kernels = {}
    for op, c in ops.items():
        if not op.startswith(("Memcpy", "Memset")):
            kernels[_kernel_name(op)] = kernels.get(_kernel_name(op), 0) + c
    named, other = {}, 0
    for counter, n in moved.items():
        for k in NAMED_KERNELS.get(counter, ()):
            named[k] = named.get(k, 0) + n
        if counter not in NAMED_KERNELS:
            other += n * _kernels_a_launch(counter)
    if kernels:
        seen = {k: kernels.get(k, 0) for k in named}
        assert seen == named, (what, "trace", seen, "wrappers", named, ops)
        rest = sum(c for k, c in kernels.items() if k not in named)
        assert not other or rest == other, (what, "trace", rest, "wrappers", other, ops)
    return (f"wrappers {moved} launch kernels {named}"
            + (f" and {other} more" if other else "")
            + f"; the trace {kernels or 'not measured'}" + (", agreed" if kernels else ""),
            sum(named.values()) + other)


def _stream_worst_cases(api, wire, urls: bytes) -> list:
    """16 MiB worst cases of ``decode_stream.cu``, each cheap for its plain
    version: (name, body, dst_len)."""
    big = api.compress(urls * 24)
    ulen, hdr = wire.varint_decode(big)
    n = 1 << 24
    run = bytearray(b"\x00a")                    # an offset-1 run: every segment hangs on the last
    run += bytes([wire.TAG_COPY_2 | (63 << 2), 1, 0]) * ((n - 1) // 64)
    run += bytes([wire.TAG_COPY_2 | (((n - 1) % 64 - 1) << 2), 1, 0])
    lit = bytearray()
    wire.emit_literal(lit, (bytes(range(256)) * (n // 256))[:n])
    ones = b"".join(b"\x00" + bytes([i & 0xFF]) for i in range(1 << 21))
    return [("urls.10K x 24", big[hdr:], ulen), ("offset-1 run of 2^24", bytes(run), n),
            ("literal of 2^24", bytes(lit), n), ("2^21 one-byte literals", ones, 1 << 21)]


def _same(name, got, want) -> int:
    """Hold a kernel's (out, produced, status) against the plain version's;
    returns the largest absolute byte difference (must be 0)."""
    out, prod, st = (t.cpu() for t in got)
    pout, pprod, pst = want
    if not (prod == pprod).all() or not (st == pst).all():
        bad = (prod != pprod) | (st != pst)
        raise AssertionError(f"{name}: produced/status differ at blocks "
                             f"{bad.nonzero().reshape(-1).tolist()[:10]}")
    err = int((out.int() - pout.int()).abs().max()) if out.numel() else 0
    if err:
        raise AssertionError(f"{name}: output bytes differ (max abs err {err})")
    return err


def _data() -> tuple[bytes, bytes, bytes, bytes]:
    """urls.10K, its golden stream, the JAX package's stream of it (the
    fixture) and the unaligned vector."""
    return tuple((DATA / f).read_bytes() for f in (
        "urls.10K", "urls.10K.snappy", "torch_ref/urls.10K.jax.snappy",
        "unaligned_uint64_test.bin"))


def _main_batch(torch, urls: bytes) -> tuple:
    """The main path's batch: B=64 blocks of 32 KiB cycling urls.10K's first
    21 (as bench.py makes them).  Returns (the 21 blocks' fragments, the
    blocks, their fragments, the fragments packed, their lengths)."""
    from csnappy_tpu_torch.models import pymodel

    distinct = [urls[i * BS : (i + 1) * BS] for i in range(21)]
    frag_of = [pymodel.compress_fragment(b) for b in distinct]
    blocks = [distinct[i % 21] for i in range(B)]
    frags = [frag_of[i % 21] for i in range(B)]
    return (frag_of, blocks, frags, *_pack(torch, frags))


def _launch_args(torch, dev, comp, lens) -> tuple:
    """Row 1's launch arguments on the card for a packed batch: the flat
    input, each block's offset, length and limit."""
    flat = comp.to(dev).reshape(-1)
    offs_b = torch.arange(len(lens), device=dev, dtype=torch.int64) * comp.shape[1]
    return flat, offs_b, lens.to(dev), torch.full((len(lens),), BS, dtype=torch.int32, device=dev)


def _pack(torch, frags):
    arr = torch.zeros((len(frags), max(len(f) for f in frags)), dtype=torch.uint8)
    for i, f in enumerate(frags):
        if f:
            arr[i, : len(f)] = torch.frombuffer(bytearray(f), dtype=torch.uint8)
    return arr, torch.tensor([len(f) for f in frags], dtype=torch.int32)


def _bound(nbytes: int) -> tuple[float, str]:
    """Least time for a function that moves ``nbytes`` and does one operation a byte."""
    from csnappy_tpu_torch.tools.timing import HBM_BYTES_PER_S, OPS_PER_S

    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nbytes / OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# the decode groups of tests/data/torch_ref/blocks.npz and their block_out;
# the rows where the JAX package answers otherwise than the reference
# decoder (JAX_DECODE_FAULTS of tools/make_torch_fixtures.py), held to the
# plain version only
DECODE_GROUPS = {"d4": 4, "d4k": 4096, "d32k": 32768, "d1k": 1024, "dadv": 32768, "far": 70000}
JAX_DECODE_FAULTS = {"far": (0,), "dadv": (3,)}


def _decode_fixtures(torch, np, dev, decode_fused) -> list:
    """Every decode group of blocks.npz on the card, equal to the plain
    version and, but on the JAX package's known faults, to the JAX answers;
    then the dadv group stamped: its resolve rounds a row (bounded by
    ceil(log2 block_out) + 1)."""
    from csnappy_tpu_torch.tools import phaseprof

    with np.load(DATA / "torch_ref" / "blocks.npz") as z:
        groups = {g: [z[f"{g}_{k}"] for k in ("comp", "lens", "out", "prod", "status")]
                  for g in DECODE_GROUPS}
    for g, (comp, lens, jout, jprod, jstat) in groups.items():
        got = decode_fused.decode_blocks(torch.from_numpy(comp).to(dev), lens, DECODE_GROUPS[g])
        _same(f"decode group {g}", got, decode_fused.decode_blocks(comp, lens, DECODE_GROUPS[g],
                                                                   device="cpu"))
        out, prod, stat = (t.cpu().numpy() for t in got)
        for i in range(len(lens)):
            if i in JAX_DECODE_FAULTS.get(g, ()):
                continue
            assert (prod[i], stat[i]) == (jprod[i], jstat[i]), (g, i)
            assert np.array_equal(out[i, : prod[i]], jout[i, : prod[i]]), (g, i)
    comp, lens = groups["dadv"][:2]
    B, width = len(lens), DECODE_GROUPS["dadv"]
    flat = torch.from_numpy(comp).to(dev).reshape(-1)
    offs = torch.arange(B, device=dev, dtype=torch.int64) * comp.shape[1]
    args = (flat, offs, torch.from_numpy(lens).to(dev),
            torch.full((B,), width, dtype=torch.int32, device=dev))
    got, st = phaseprof.stamped_decode(decode_fused.decode_blocks, args, width)
    _same("decode group dadv, stamped", got, decode_fused.decode_blocks(comp, lens, width,
                                                                        device="cpu"))
    rounds = st[:, -1].tolist()
    bound = (width - 1).bit_length() + 1
    assert max(rounds) <= bound and rounds[0] >= 1, rounds
    print(f"[decode] groups {sorted(DECODE_GROUPS)} of blocks.npz equal to the JAX answers (but "
          f"the JAX faults {JAX_DECODE_FAULTS}) and to plain on the card; dadv resolve rounds a "
          f"row {rounds} (bound {bound}), windows {st[:, -3].tolist()}, tags "
          f"{st[:, -2].tolist()}; the deep chain (8,191 copies) exact in {rounds[0]} rounds, "
          f"launched in {_launch_ms(decode_fused, decode_fused.decode_blocks, args, width):.4f} "
          f"ms (the whole group)", flush=True)
    return rounds


def _launch_ms(decode_fused, wrapper, args, width: int, n: int = 20) -> float:
    """Milliseconds of one launch of the decoder's kernels (CUDA events)."""
    from csnappy_tpu_torch.tools.timing import time_ms

    return time_ms(lambda: decode_fused._launch(wrapper, *args, width), n=n)


# the wide group of tests/data/torch_ref/wide.npz and its block_out; the
# rows where the JAX package answers otherwise than the reference decoder
WIDE_GROUPS = {"w64k": 65536, "w70k": 70000, "w256k": 1 << 18, "w1m": 1 << 20}
WIDE_JAX = ("w64k", "w70k")
WIDE_JAX_FAULTS = {"w70k": (0,), "w64k": (6, 7)}
WIDE_WIDTHS = (32769, 65536, 70000, 131073, 1 << 18, 1 << 20, 1 << 24)
WIDE_TIMED = (49152, 65536, 70000, 131072)     # phase 5, one row and B=64 rows
WIDE_REPEATS = 50                               # phase 2: the main path's wide batch again


def wide_cases(width: int, seed: int) -> list:
    """Rows of ``width`` bytes for the wide kernels, cheap for the plain
    version: urls.10K repeated as 32 KiB fragments, an offset-1 run, COPY_4
    reads up to 100,000 back, and events in the first and the last segment:
    [(name, fragment)].  Shared with the card tests."""
    import numpy as np

    from csnappy_tpu_torch.models import pymodel, wire

    rng = np.random.default_rng(seed)
    urls = (DATA / "urls.10K").read_bytes()
    data = (urls * (width // len(urls) + 1))[:width]
    frags = b"".join(pymodel.compress_fragment(data[i : i + 32768])
                     for i in range(0, width, 32768))
    run = bytearray(b"\x00z") + bytes([wire.TAG_COPY_2 | (63 << 2), 1, 0]) * ((width - 1) // 64)
    if (width - 1) % 64:
        run += bytes([wire.TAG_COPY_2 | (((width - 1) % 64 - 1) << 2), 1, 0])
    far = bytearray()
    lit = rng.integers(0, 256, min(width, 200000) // 2, dtype=np.uint8).tobytes()
    wire.emit_literal(far, lit)
    op = len(lit)
    while op < width:
        n = min(64, width - op)
        off = int(rng.integers(1, op + 1))
        far += bytes([wire.TAG_COPY_4 | ((n - 1) << 2)]) + off.to_bytes(4, "little")
        op += n
    head = pymodel.compress_fragment(urls[:1000])
    short = b"".join(pymodel.compress_fragment(data[i : min(i + 32768, width - 64)])
                     for i in range(0, width - 64, 32768))
    return [("urls", frags), ("offset-1 run", bytes(run)), ("far COPY_4", bytes(far)),
            ("bad offset in the first segment", head + bytes([wire.TAG_COPY_2 | (7 << 2)])
             + (5000).to_bytes(2, "little") + frags),
            ("cut in the first segment", head[:-1]),
            ("overrun at the last byte", frags + b"\x00!"),
            ("bad offset in the last segment", short + bytes([wire.TAG_COPY_4 | (7 << 2)])
             + (width + 5).to_bytes(4, "little")),
            ("cut at the end", frags[:-1]), ("empty", b"")]


def main_path_batch() -> tuple:
    """The main path's ``decode_segments`` batch of rows past 32 KiB
    (``tools/hygiene.main_path_batch``): the body of urls.10K.snappy
    (limit 702,087), urls.10K's first 32 KiB as one fragment (limit 32,768)
    and the first w256k row of wide.npz (limit 2^18: urls.10K's first 2^18
    B as 32 KiB fragments, 127,497 B of input), back to back at unaligned
    offsets: (body, offsets, lengths, limits, the rows' decoded bytes).
    Shared with the card tests."""
    import numpy as np

    from csnappy_tpu_torch.models import pymodel
    from csnappy_tpu_torch.tools import hygiene

    rows, limits = hygiene.main_path_batch()
    offs = np.cumsum([0] + [len(f) for f in rows[:-1]])
    want = [pymodel.decompress_noheader(f, d) for f, d in zip(rows, limits)]
    return b"".join(rows), offs, np.array([len(f) for f in rows]), np.array(limits), want


def wide_repeats(n: int, dev=None) -> dict:
    """:func:`main_path_batch` through ``decode_segments`` ``n`` times on the
    card, from host bytes and from a card tensor in turn, with the body as
    one 702,087-byte ``decode_blocks`` row between them; every call's bytes,
    ``produced`` and status held against the batch's known answers.  Before
    each call the caching allocator's pool is poisoned
    (``tools/hygiene.poison_pool``: blocks of the call's sizes held and
    freed, then every free block filled with a byte that changes from call
    to call, never 0), and each output is asserted to lie in that poisoned
    memory: a byte that no kernel writes reads wrong, where a repeat in an
    unpoisoned pool finds the last call's right answer.  Returns the calls
    made, those that differed (by kind) and the outputs asserted poisoned."""
    import numpy as np
    import torch

    from csnappy_tpu_torch.ops import decode_fused
    from csnappy_tpu_torch.tools import hygiene

    dev = torch.device(dev or "cuda")
    body, offs, lens, dl, want = main_path_batch()
    width = int(dl.max())
    ref = torch.zeros((len(want), width), dtype=torch.uint8)
    for i, w in enumerate(want):
        ref[i, : len(w)] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
    ref = ref.to(dev)
    rprod = torch.tensor([len(w) for w in want], dtype=torch.int32, device=dev)
    bdev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    row = torch.frombuffer(bytearray(body[: lens[0]]), dtype=torch.uint8).to(dev)[None, :]
    bad = {"segments": 0, "blocks": 0}
    sizes = (len(want) * width + (1 << 20), 1 << 20)       # the outputs and workspace; small ones
    poisoned = 0

    def landed(ranges, *ts):
        for t in ts:
            assert hygiene.in_ranges(t, ranges), "an output of the wide batch missed the poison"
        return len(ts)

    for i in range(n):
        ranges = hygiene.poison_pool(1 + (2 * i * 97) % 255, sizes, dev)
        out, prod, st = decode_fused.decode_segments(body if i % 2 else bdev, offs, lens, dl)
        poisoned += landed(ranges, out, prod, st)
        if not (torch.equal(out, ref) and torch.equal(prod, rprod) and not st.any()):
            bad["segments"] += 1
        ranges = hygiene.poison_pool(1 + (2 * i * 97 + 97) % 255, sizes, dev)
        bo, bp, bs = decode_fused.decode_blocks(row, [int(lens[0])], width)
        poisoned += landed(ranges, bo, bp, bs)
        if not (torch.equal(bo[0], ref[0]) and int(bp[0]) == width and int(bs[0]) == 0):
            bad["blocks"] += 1
    return {"calls": 2 * n, "differed": bad, "poisoned": poisoned}


def _wide_times(torch, np, dev, decode_fused, urls: bytes, body: bytes) -> dict:
    """Phase 5's measurements of the wide kernels (``csrc/decode_wide.cu``):
    rows of urls.10K data at each width of ``WIDE_TIMED`` (one row, and 64
    rows), urls.10K.snappy's body as one row of 702,087 B and urls.10K x
    24's body as one row of 16,850,088 B, each with its launch (CUDA
    events), its kernels alone (torch.profiler), a call, a lone call (host
    clock), the SM cycles of each kernel's slowest block by phase and the
    chains' spans (stamps), the bound (bytes over 3.35 TB/s) and the plain
    version; ``decode_stream.cu`` on the two whole bodies beside them.
    Returns the ``kernels`` line's measured fields of ``decode_blocks_wide``
    (the 702,087-byte row) and ``decode_segments_wide`` (the main path's
    mixed batch), with every case under ``cases``."""
    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import pymodel, wire
    from csnappy_tpu_torch.ops import decode_stream as ds
    from csnappy_tpu_torch.tools import phaseprof
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    big = api.compress(urls * 24)
    ulen, hdr = wire.varint_decode(big)
    long = (urls * 2)
    cases = []
    for width in WIDE_TIMED:
        rows = [b"".join(pymodel.compress_fragment(long[o + i : o + min(i + 32768, width)])
                         for i in range(0, width, 32768))
                for o in range(0, 64 * 9973, 9973)]
        cases += [(f"{width} B x 1", rows[:1], width), (f"{width} B x 64", rows, width)]
    cases += [("urls.10K.snappy body as one row", [body], len(urls)),
              ("urls.10K x 24 body as one row", [big[hdr:]], ulen)]
    recs = {}
    for label, frags, width in cases:
        comp, lens = _pack(torch, frags)
        B = len(frags)
        cdev, lens_np = comp.to(dev), lens.numpy()
        args = (cdev.reshape(-1), torch.arange(B, device=dev, dtype=torch.int64) * comp.shape[1],
                lens.to(dev), torch.full((B,), width, dtype=torch.int32, device=dev))
        plan = decode_fused.plan_on(dev, lens_np, [width] * B, width)
        got, (chain, seg) = phaseprof.stamped_wide(decode_fused.decode_blocks, args, width)
        t0 = time.perf_counter()
        want = decode_fused.decode_blocks(comp, lens, width, device="cpu")
        plain_ms = (time.perf_counter() - t0) * 1e3
        _same(f"wide {label}", got, want)
        assert (want[2] == 0).all() and (want[1] == width).all(), label
        reps = 20 if width * B < 1 << 24 else 5
        call = lambda: decode_fused.decode_blocks(cdev, lens_np, width)   # noqa: E731
        prof = device_profile(call, reps)
        summ = phaseprof.wide_summary(chain, seg)
        nbytes = int(lens.sum()) + 32 * B + B * width + 8 * B
        bound_ms, bound_by = _bound(nbytes)
        rec = {"B": B, "width": width, "in": int(lens.sum()), "chunks": plan[1],
               "segments": plan[2],
               "ms": time_ms(lambda: decode_fused._launch(decode_fused.decode_blocks, *args, width,
                                                          plan=plan), n=reps),
               "kernels_ms": sum(v for k, v in prof["kernels"].items() if "wide_" in k) or None,
               "kernels": prof["kernels"], "call_ms": time_ms(call, n=reps),
               "lone_ms": _lone_ms(torch, call, reps), "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "cycles": {k: {"slowest": v["cycles"], "phases": v["phases"],
                              "span_ns": v["span_ns"]} for k, v in summ.items()},
               "waited": int((seg[:, decode_fused.WIDE_SEG_STAMPS.index("externals")] > 0).sum()),
               "max_rounds": int(seg[:, decode_fused.WIDE_SEG_STAMPS.index("rounds")].max())}
        rec["GBps"] = B * width / (rec["ms"] * 1e-3) / 1e9
        assert rec["max_rounds"] <= 16, rec["max_rounds"]
        if B == 1 and width in (len(urls), ulen):      # decode_stream.cu on the same body
            bd = args[0]
            cap, limit = ds._limits(bd.numel(), width)
            dsp = device_profile(lambda: ds.decode_stream(bd, width, dev), reps)
            rec["decode_stream"] = {"ms": time_ms(lambda: ds._launch(bd, cap, limit), n=reps),
                                    "kernels_ms": dsp["device_ms"] or None}
        recs[label] = rec
        print(f"[wide] {label}: {B} x {width} B from {rec['in']} B ({rec['chunks']} chunks, "
              f"{rec['segments']} segments, {rec['waited']} waited on a flag): launched "
              f"{rec['ms']:.4f} ms ({rec['GBps']:.3f} GB/s), kernels alone "
              f"{_or_not_measured(rec['kernels_ms'])} {rec['kernels']}, a call "
              f"{rec['call_ms']:.4f} ms, a lone call {rec['lone_ms']:.4f} ms (host clock); bound "
              f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B); plain {plain_ms:.1f} ms (host CPU); "
              f"SM cycles {rec['cycles']}; resolve rounds <= {rec['max_rounds']}"
              + (f"; decode_stream.cu on the same body launched {rec['decode_stream']['ms']:.4f} "
                 f"ms, kernels alone {_or_not_measured(rec['decode_stream']['kernels_ms'])}"
                 if "decode_stream" in rec else ""), flush=True)
    for k in decode_fused.WIDE_KERNELS:
        frame, used = _ptxas(k, "decode_wide")
        print(f"[wide] {k} ptxas -v: {frame}; {used}; dynamic shared memory "
              f"{decode_fused.smem_bytes(k)} B a block", flush=True)
    # decode_segments_wide: the main path's batch (urls.10K.snappy's body, a
    # 32 KiB fragment, a w256k row) read in place
    mbody, moffs, mlens, mdl, _ = main_path_batch()
    mdev = torch.frombuffer(bytearray(mbody), dtype=torch.uint8).to(dev)
    margs = (mdev, torch.as_tensor(moffs, dtype=torch.int64, device=dev),
             torch.as_tensor(mlens, dtype=torch.int32, device=dev),
             torch.as_tensor(mdl, dtype=torch.int32, device=dev))
    t0 = time.perf_counter()
    decode_fused.decode_segments(mbody, moffs, mlens, mdl, device="cpu")
    mplain = (time.perf_counter() - t0) * 1e3
    mcall = lambda: decode_fused.decode_segments(mdev, moffs, mlens, mdl)   # noqa: E731
    mprof = device_profile(mcall)
    mbytes = int(mlens.sum()) + 32 * 3 + 3 * len(urls) + 8 * 3
    mbound, mby = _bound(mbytes)
    mplan = decode_fused.plan_on(dev, mlens, mdl, len(urls))
    seg_rec = {"ms": time_ms(lambda: decode_fused._launch(decode_fused.decode_segments, *margs,
                                                          len(urls), plan=mplan)),
               "plain_ms": mplain, "bound_ms": mbound, "bound_by": mby, "library_ms": None,
               "kernels_ms": sum(v for k, v in mprof["kernels"].items() if "wide_" in k) or None,
               "call_ms": time_ms(mcall), "lone_ms": _lone_ms(torch, mcall), "bytes": mbytes}
    print(f"[wide] decode_segments over the main path's batch (limits {mdl.tolist()}): launched "
          f"{seg_rec['ms']:.4f} ms, kernels alone {_or_not_measured(seg_rec['kernels_ms'])}, a "
          f"call {seg_rec['call_ms']:.4f} ms, a lone call {seg_rec['lone_ms']:.4f} ms; bound "
          f"{mbound:.5f} ms by {mby}; plain {mplain:.1f} ms", flush=True)
    head = recs["urls.10K.snappy body as one row"]
    blocks_rec = {k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "kernels_ms",
                                       "call_ms", "lone_ms", "bytes", "GBps", "cycles")}
    blocks_rec.update(library_ms=None, cases=recs)
    return {"decode_blocks": blocks_rec, "decode_segments": seg_rec}


def _wide_checks(torch, np, dev, decode_fused) -> dict:
    """Phase 2's rows past 32 KiB (``csrc/decode_wide.cu``): every group of
    wide.npz equal to the plain version, the oracle's stored answers and,
    but on the JAX package's known faults, the JAX answers; every width of
    ``WIDE_WIDTHS`` on :func:`wide_cases` equal to the plain version, with
    ``decode_segments`` reading the same rows in place at mixed limits; one
    ``decode_segments`` batch mixing widths.  Returns the largest byte
    difference of each entry point (0)."""
    with np.load(DATA / "torch_ref" / "wide.npz") as z:
        ref = {k: z[k] for k in z.files}
    before = dict(decode_fused.launches_by_kernel)
    for g, width in WIDE_GROUPS.items():
        comp, lens = ref[f"{g}_comp"], ref[f"{g}_lens"]
        got = decode_fused.decode_blocks(torch.from_numpy(comp).to(dev), lens, width)
        _same(f"wide group {g}", got, decode_fused.decode_blocks(comp, lens, width, device="cpu"))
        out, prod, stat = (t.cpu().numpy() for t in got)
        assert prod.tolist() == ref[f"{g}_oracle_prod"].tolist(), g
        assert stat.tolist() == ref[f"{g}_oracle_status"].tolist(), g
        for i in range(len(lens)):
            assert hashlib.sha256(out[i].tobytes()).digest() == \
                ref[f"{g}_oracle_sha256"][i].tobytes(), (g, i)
            if g in WIDE_JAX and i not in WIDE_JAX_FAULTS.get(g, ()):
                assert (prod[i], stat[i]) == (ref[f"{g}_prod"][i], ref[f"{g}_status"][i]), (g, i)
                assert np.array_equal(out[i, : prod[i]], ref[f"{g}_out"][i, : prod[i]]), (g, i)
    print(f"[decode] wide groups {sorted(WIDE_GROUPS)} of wide.npz equal to plain and the oracle "
          f"on the card, and to the JAX answers but the JAX faults {WIDE_JAX_FAULTS}", flush=True)
    errs = {"decode_blocks": 0, "decode_segments": 0}
    for width in WIDE_WIDTHS:
        cases = wide_cases(width, width)
        frags = [f for _, f in cases]
        comp, lens = _pack(torch, frags)
        got = decode_fused.decode_blocks(comp.to(dev), lens, width)
        want = decode_fused.decode_blocks(comp, lens, width, device="cpu")
        errs["decode_blocks"] = max(errs["decode_blocks"], _same(f"wide rows at {width}", got, want))
        stat = want[2].tolist()
        assert stat[:3] == [0, 0, 0] and set(stat[3:8]) == {-3, -5}, (width, stat)
        body = b"".join(frags)
        offs = np.cumsum([0] + [len(f) for f in frags[:-1]])
        dl = np.array([width, width - 1, 40000, width, width, width + 1, width, width, 0])
        bdev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
        errs["decode_segments"] = max(errs["decode_segments"], _same(
            f"wide segments at {width}", decode_fused.decode_segments(bdev, offs, lens.numpy(), dl),
            decode_fused.decode_segments(body, offs, lens.numpy(), dl, device="cpu")))
        print(f"[decode] width {width}: {len(cases)} rows ({', '.join(n for n, _ in cases)}) "
              f"equal to plain on the card, statuses {stat}; decode_segments over the same "
              f"rows at limits {dl.tolist()} equal to plain", flush=True)
    rows = [f for g in ("w64k", "w256k", "w1m") for f in (
        ref[f"{g}_comp"][i, : ref[f"{g}_lens"][i]].tobytes() for i in range(len(ref[f"{g}_lens"])))]
    body = b"".join(rows)
    offs = np.cumsum([0] + [len(f) for f in rows[:-1]])
    lens = np.array([len(f) for f in rows])
    dl = np.array([65536] * 8 + [1 << 18] * 3 + [1 << 20] * 3)
    dl[::3] = 40000                                   # some rows narrower than the batch's width
    bdev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    errs["decode_segments"] = max(errs["decode_segments"], _same(
        "decode_segments mixing widths", decode_fused.decode_segments(bdev, offs, lens, dl),
        decode_fused.decode_segments(body, offs, lens, dl, device="cpu")))
    runs = {k: v - before[k] for k, v in decode_fused.launches_by_kernel.items()}
    calls = len(WIDE_GROUPS) + 2 * len(WIDE_WIDTHS) + 1
    assert runs == {"decode_kernel": 0, **dict.fromkeys(decode_fused.WIDE_KERNELS, calls)}, runs
    print(f"[decode] one decode_segments batch of {len(rows)} rows at limits {dl.tolist()} equal "
          f"to plain; the wide kernels' launches {runs}", flush=True)
    return errs


def _lone_ms(torch, fn, n: int = 20) -> float:
    """Median host milliseconds of one ``fn()`` alone, synchronised before and after."""
    def one() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    return statistics.median(one() for _ in range(n))


def _whole_stream(torch, np, dev, urls: bytes, golden: bytes, unaligned: bytes, card: str):
    """Phase 6: the whole-stream slice (scan_segments.cu, decode_stream.cu,
    decode_jnp's torch ops) against its plain versions and the JAX fixture,
    the API's whole-stream routes with launch counts, and times."""
    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import wire
    from csnappy_tpu_torch.ops import decode_fused, decode_jnp, decode_stream, decode_ws
    from csnappy_tpu_torch.runtime import native
    from csnappy_tpu_torch.tools.timing import time_ms

    def u8(b: bytes):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8)

    def err(a, b) -> int:
        """Largest absolute difference of two byte tensors of one length (0 if empty)."""
        assert a.numel() == b.numel()
        return int((a.cpu().int() - b.cpu().int()).abs().max()) if a.numel() else 0

    def sha(b: bytes) -> list:
        return list(hashlib.sha256(b).digest())

    z = np.load(DATA / "torch_ref" / "streams.npz")
    errs = {"scan_segments": 0, "decode_stream": 0, "decode_jnp": 0}
    nstream = 0

    def scan_err(body: bytes, nslots) -> int:
        """The scan on the card against its plain walk at each slot count."""
        worst = 0
        for nslot in nslots:
            seg, meta = decode_ws.scan_segments(u8(body).to(dev), nslot, dev)
            pseg, pmeta = decode_ws.scan_plain(u8(body), nslot)
            worst = max(worst, int((seg.cpu() - pseg).abs().max()),
                        int((meta[:3].cpu() - pmeta[:3]).abs().max()))
        return worst

    adv = np.load(DATA / "torch_ref" / "scan_adv.npz")
    for i, name in enumerate(str(s) for s in adv["names"]):
        body, dst = adv["body"][adv["offs"][i] : adv["offs"][i + 1]].tobytes(), int(adv["dst_len"][i])
        nseg = -(-dst // BS)
        errs["scan_segments"] = max(errs["scan_segments"], scan_err(body, (nseg + 1, 2, 1)))
        seg, meta = decode_ws.scan_segments(u8(body).to(dev), nseg + 1, dev)
        want = adv["jax_seg"][adv["jax_seg_offs"][i] : adv["jax_seg_offs"][i + 1]]
        assert seg[:nseg].cpu().numpy().tolist() == want.tolist(), name
        assert meta[:3].cpu().numpy().tolist() == adv["jax_meta"][i].tolist(), name
    for i, name in enumerate(str(s) for s in z["names"]):
        body, dst = z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(), int(z["dst_len"][i])
        nseg = -(-dst // BS)
        bdev = u8(body).to(dev)
        seg, meta = decode_ws.scan_segments(bdev, nseg + 1, dev)
        errs["scan_segments"] = max(errs["scan_segments"], scan_err(body, (nseg + 1, 2, 1)))
        if decode_ws.plan(len(body), dst) is not None:      # the JAX scan's seg[:nseg], meta[:3]
            want = z["ws_seg"][z["ws_seg_offs"][i] : z["ws_seg_offs"][i + 1]]
            assert seg[:nseg].cpu().numpy().tolist() == want.tolist(), name
            assert meta[:3].cpu().numpy().tolist() == z["ws_meta"][i].tolist(), name
        res = decode_ws.decompress_noheader_ws(bdev, dst, dev)
        assert (res is not None) == bool(z["ws_bytes"][i]), name
        assert res is None or sha(res) == z["ws_sha"][i].tolist(), name
        for cap in sorted({dst, max(0, dst - 5000), dst // BS * BS}):
            got = decode_stream.decode_stream(bdev, cap, dev)
            want = decode_stream.decode_stream(body, cap, "cpu")
            p = int(want[1])
            assert (int(got[1]), int(got[2])) == (p, int(want[2])), (name, cap)
            errs["decode_stream"] = max(errs["decode_stream"], err(got[0][:p], want[0][:p]))
            nstream += 1
            if cap == dst:
                assert (p, int(got[2])) == (z["st_prod"][i], z["st_status"][i]), name
                assert sha(got[0][:p].cpu().numpy().tobytes()) == z["st_sha"][i].tolist(), name
        jg = decode_jnp.decompress_noheader_np(bdev, dst, dev)
        jc = decode_jnp.decompress_noheader_np(body, dst, "cpu")
        assert jg[1:] == jc[1:] == (z["jnp_prod"][i], z["jnp_status"][i]), name
        assert sha(jg[0].tobytes()) == z["jnp_sha"][i].tolist(), name
        errs["decode_jnp"] = max(errs["decode_jnp"], err(torch.from_numpy(jg[0]), torch.from_numpy(jc[0])))
    sadv = np.load(DATA / "torch_ref" / "stream_adv.npz")
    for i, name in enumerate(str(s) for s in sadv["names"]):
        body = sadv["body"][sadv["offs"][i] : sadv["offs"][i + 1]].tobytes()
        bdev = u8(body).to(dev)
        for j, cap in enumerate(sadv["limits"][i].tolist()):
            got = decode_stream.decode_stream(bdev, cap, dev)
            want = decode_stream.decode_stream(body, cap, "cpu")
            p = int(want[1])
            assert (int(got[1]), int(got[2])) == (p, int(want[2])), (name, cap)
            assert (p, int(got[2])) == (sadv["jax_prod"][i][j], sadv["jax_status"][i][j]), (name, cap)
            assert sha(got[0][:p].cpu().numpy().tobytes()) == sadv["jax_sha"][i][j].tolist(), name
            errs["decode_stream"] = max(errs["decode_stream"], err(got[0][:p], want[0][:p]))
            nstream += 1
    worst = _stream_worst_cases(api, wire, urls)
    for name, body, dst in worst:
        bdev = u8(body).to(dev)
        for cap in (dst, max(0, dst - 5000), dst // BS * BS):
            got = decode_stream.decode_stream(bdev, cap, dev)
            want = decode_stream.decode_stream(body, cap, "cpu")
            p = int(want[1])
            assert (int(got[1]), int(got[2])) == (p, int(want[2])), (name, cap)
            errs["decode_stream"] = max(errs["decode_stream"], err(got[0][:p], want[0][:p]))
            nstream += 1
    torch.cuda.synchronize()
    assert not any(errs.values()), errs
    unaligned_stream = (DATA / "unaligned_uint64_test.snappy").read_bytes()
    for label, stream in (("urls.10K.snappy", golden), ("unaligned_uint64_test.snappy", unaligned_stream)):
        ulen, hdr = wire.varint_decode(stream)
        bdev = u8(stream[hdr:]).to(dev)
        ops = _device_ops(torch, lambda: decode_stream.decode_stream(bdev, ulen, dev),
                          f"decode_stream {label}")
        kern = {k: v for k, v in ops.items() if not k.startswith(("Memcpy", "Memset"))}
        memsets = sum(v for k, v in ops.items() if k.startswith("Memset"))
        assert sorted(kern.values()) == [1, 1] and memsets <= 1, ops
        assert any("chain_kernel" in k for k in kern) and any("segment_kernel" in k for k in kern)
        assert not any(k.startswith("Memcpy") for k in ops), ops
        print(f"[stream] one decode_stream call on {label}: device kernels {kern}, memsets "
              f"{memsets} (torch.profiler)", flush=True)
    print(f"[stream] {len(z['names'])} fixture streams, the {len(sadv['names'])} of stream_adv.npz "
          f"and the 16 MiB worst cases {[w[0] for w in worst]}: decode_stream equal to plain at "
          f"the exact, -5000 and multiple-of-32768 limits, stream_adv also to the JAX kernel",
          flush=True)
    print(f"[stream] {len(z['names'])} fixture streams and the {len(adv['names'])} adversarial "
          f"streams of scan_adv.npz: scan_segments (seg, meta[:3]) equal to plain at nslot = nseg "
          f"+ 1, 2 and 1, and to the JAX scan; decode_ws bytes-or-None equal to the JAX pipeline; "
          f"decode_stream equal to plain ({nstream} limits: exact, -5000, multiple of 32768) "
          f"and to the JAX kernel; decode_jnp on the card equal to the CPU and the JAX decoder; "
          f"max abs err {errs}", flush=True)

    # main path: every whole-stream route through the API, counts at 0 first
    big = urls * 24                                   # 16.85 MB, 515 segments
    big_comp = api.compress(big)
    lit = bytes(range(256)) * 160
    far = bytearray()
    wire.emit_literal(far, lit)
    far += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (40000).to_bytes(4, "little")
    counted = {"scan_segments": decode_ws.scan_segments,
               "decode_segments": decode_fused.decode_segments,
               "decode_stream": decode_stream.decode_stream,
               "decode_jnp": decode_jnp.decompress_noheader_np}
    host_scan = native.scan_segments
    host_calls = []
    native.scan_segments = lambda *a, **k: host_calls.append(1) or host_scan(*a, **k)
    routes = {}

    def via_host_scan(stream: bytes) -> bytes:
        """The host-scan segmentable route: decode_ws answers None, so the
        host scan routes the stream to one decode_segments launch."""
        ws = decode_ws.decompress_noheader_ws
        decode_ws.decompress_noheader_ws = lambda *a, **k: None
        try:
            return api.decompress(stream)
        finally:
            decode_ws.decompress_noheader_ws = ws
    try:
        for w in counted.values():
            w.launches = 0
        for route, fn, want in (
                ("urls.10K.snappy", lambda: api.decompress(golden), urls),
                ("unaligned_uint64_test.snappy", lambda: api.decompress(
                    (DATA / "unaligned_uint64_test.snappy").read_bytes()), unaligned),
                ("copy4_offset_40000", lambda: api.decompress_noheader(bytes(far), len(lit) + 8),
                 lit + lit[-40000 : -40000 + 8]),
                ("urls.10K x24", lambda: api.decompress(big_comp), big),
                ("urls.10K.snappy via the host scan", lambda: via_host_scan(golden), urls)):
            before = {k: w.launches for k, w in counted.items()}
            nhost = len(host_calls)
            assert fn() == want, route
            routes[route] = {k: w.launches - before[k] for k, w in counted.items()
                             if w.launches > before[k]}
            routes[route]["host_scan"] = len(host_calls) - nhost
    finally:
        native.scan_segments = host_scan
    launches = {k: w.launches for k, w in counted.items()}
    assert all(n > 0 for n in launches.values()), launches
    for route in ("urls.10K.snappy", "urls.10K x24"):
        assert routes[route] == {"scan_segments": 1, "decode_segments": 1, "host_scan": 0}, routes
    assert routes["urls.10K.snappy via the host scan"] == {"decode_segments": 1, "host_scan": 1}, \
        routes
    assert routes["unaligned_uint64_test.snappy"].get("decode_stream") == 1, routes
    assert routes["copy4_offset_40000"].get("decode_jnp") == 1, routes
    print(f"[stream-main] api whole-stream routes on the card: {routes}; launches {launches}",
          flush=True)

    # times: the 702 KB reference stream and the 16 MiB stream
    rows = {}
    scan_rec = _scan_phase(torch, np, dev, golden, len(urls), big_comp, len(big))
    unaligned_body = unaligned_stream[wire.varint_decode(unaligned_stream)[1]:]
    stream_rec = _stream_phase(torch, np, dev, [
        ("702KB", golden[wire.varint_decode(golden)[1]:], len(urls)),
        ("unaligned_uint64_test.snappy", unaligned_body, wire.varint_decode(unaligned_stream)[0]),
        ("16MiB", big_comp[wire.varint_decode(big_comp)[1]:], len(big))]
        + [w for w in worst if w[0] != "urls.10K x 24"])
    for label, stream, dst in (("702KB", golden, len(urls)), ("16MiB", big_comp, len(big))):
        body = stream[wire.varint_decode(stream)[1]:]
        nseg = -(-dst // BS)
        bdev, bcpu = u8(body).to(dev), u8(body)
        reps = 20 if label == "702KB" else 5
        tags = int(decode_ws.scan_plain(bcpu, nseg + 1)[1][3])     # the whole chain: every tag
        comp = torch.nn.functional.pad(bdev.int(), (0, decode_jnp._bucket(len(body)) - len(body)))
        ms = {"scan_segments": time_ms(lambda: decode_ws.scan_segments(bdev, nseg + 1, dev),
                                        n=reps),
              "decode_stream": time_ms(lambda: decode_stream.decode_stream(bdev, dst, dev),
                                        n=reps),
              "decode_jnp": time_ms(lambda: decode_jnp._decode_core(
                  comp, len(body), dst, decode_jnp._bucket(dst)), n=reps)}
        rec = scan_rec[label]
        print(f"[times] {label} stream ({len(body)} B in, {dst} B out, {nseg} segments, {tags} "
              f"tags, {rec['chunks']} chunks): scan_segments {ms['scan_segments']:.4f} ms a call "
              f"(CUDA events), host native.scan_segments {rec['host_scan_ms']:.4f} ms; decode_ws "
              f"pipeline {rec['decode_ws_ms']:.4f} ms host clock "
              f"({dst / rec['decode_ws_ms'] / 1e6:.3f} GB/s of output)", flush=True)
        for name, route, src, replaces, nbytes in (
                ("scan_segments", "cuda", "csnappy_tpu_torch/csrc/scan_segments.cu",
                 "csnappy_tpu/ops/decode_ws.py:268", len(body) + 4 * (nseg + 1) + 32),
                ("decode_stream", "cuda", "csnappy_tpu_torch/csrc/decode_stream.cu",
                 "csnappy_tpu/ops/decode_stream.py:531", len(body) + dst + 16),
                ("decode_jnp", "torch-ops", "csnappy_tpu_torch/ops/decode_jnp.py",
                 "csnappy_tpu/ops/decode_jnp.py:184", len(body) + dst)):
            bound_ms, bound_by = _bound(nbytes)
            srec = stream_rec[label]
            chain = (f"{rec['visited']} chunks chained" if name == "scan_segments" else
                     f"{srec['visited']} chunks chained, {srec['waited']} segments waited on"
                     if name == "decode_stream" else f"serial chain {tags} tags")
            print(f"[times] {label} {name}: {ms[name]:.4f} ms, bound {bound_ms:.5f} ms by "
                  f"{bound_by} ({nbytes} B), {chain}, {launches[name]} launches on the main "
                  f"path", flush=True)
            if label == "702KB":
                plain = {"scan_segments": lambda: decode_ws.scan_plain(bcpu, nseg + 1),
                         "decode_stream": lambda: decode_stream.decode_stream(bcpu, dst, "cpu"),
                         "decode_jnp": lambda: decode_jnp.decompress_noheader_np(bcpu, dst, "cpu")}
                rows[name] = {"name": name, "route": route, "source": src, "replaces": replaces,
                              "launches": launches[name], "max_abs_err": errs[name],
                              "ms": ms[name], "plain_ms": _host_ms(plain[name]),
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                              "bytes": nbytes}
                if name == "decode_jnp":
                    rows[name]["chain_steps"] = tags
            else:
                rows[name].update(ms_16MiB=ms[name], bound_ms_16MiB=bound_ms)
                if name == "decode_jnp":
                    rows[name]["chain_steps_16MiB"] = tags
        key = "" if label == "702KB" else "_16MiB"
        rows["scan_segments"].update({f"{k}{key}": v for k, v in rec.items()})
    rows["scan_segments"].update(scan_rec["shared"])
    rows["decode_stream"].update(
        chain_links={k: [r["visited"], r["waited"]] for k, r in stream_rec.items()},
        streams={k: {f: r[f] for f in ("in", "out", "kernel_ms", "launch_ms", "call_ms", "lone_ms",
                                       "chunk_us", "segment_us")} for k, r in stream_rec.items()},
        phases_cycles={k: {"chain": r["chain_phases"], "segment": r["segment_phases"]}
                       for k, r in stream_rec.items()},
        ptxas=stream_rec["702KB"]["ptxas"])
    print(f"[times] card {card}", flush=True)
    return list(rows.values())


def _stream_phase(torch, np, dev, cases) -> dict:
    """Phase 6's measurements of ``decode_stream.cu`` on each (label, body,
    dst_len): the kernels alone (torch.profiler), the launch and a call
    (CUDA events), a lone call (host clock), the SM cycles of each phase of
    both kernels (the slowest block and the median visited one, from the
    stamps), and the chains' spans (%globaltimer): from the first chunk's
    publish to the stop's, a chunk; from the first segment's flag to the
    last's, a segment.  Returns a record for each label."""
    from csnappy_tpu_torch.ops import decode_stream as ds
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    def phases(st, names, live):
        cyc = st[:, : len(names)]
        slow = int(np.argmax(cyc.sum(1)))
        live = live if live.any() else np.ones(len(st), bool)
        return {"slowest": {"block": slow, "cycles": int(cyc[slow].sum()),
                            **dict(zip(names, cyc[slow].tolist()))},
                "median": dict(zip(names, np.median(cyc[live], 0).tolist()))}

    frame, used = _ptxas("segment_kernel", "decode_stream")
    cframe, cused = _ptxas("chain_kernel", "decode_stream")
    out = {}
    for label, body, dst in cases:
        bdev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
        cap, limit = ds._limits(len(body), dst)
        reps = 20 if len(body) < 1 << 20 else 5
        st = torch.zeros(ds.stamp_count(len(body), cap), dtype=torch.int64, device=dev)
        got = ds._launch(bdev, cap, limit, st)
        bare = ds.decode_stream(bdev, dst, dev)
        assert torch.equal(got[0], bare[0]) and int(got[1]) == int(bare[1]) == dst, label
        chain, seg = ds.split_stamps(st, len(body), cap)
        visited = chain[:, 4] == 1
        cns = chain[visited, 7]
        sns = seg[seg[:, 12] > 0, 12]
        prof = device_profile(lambda: ds.decode_stream(bdev, dst, dev), reps)
        rec = {"in": len(body), "out": dst, "chunks": len(chain), "segments": len(seg),
               "visited": int(visited.sum()), "waited": int((seg[:, 11] > 0).sum()),
               "kernel_ms": prof["device_ms"] or None, "kernels": prof["kernels"],
               "launch_ms": time_ms(lambda: ds._launch(bdev, cap, limit), n=reps),
               "call_ms": time_ms(lambda: ds.decode_stream(bdev, dst, dev), n=reps),
               "lone_ms": _lone_ms(torch, lambda: ds.decode_stream(bdev, dst, dev), reps),
               "chunk_us": float(cns.max() - cns.min()) / 1e3 / max(1, len(cns) - 1),
               "segment_us": float(sns.max() - sns.min()) / 1e3 / max(1, len(sns) - 1),
               "chain_phases": phases(chain, ds.CHAIN_STAMPS[:4], visited),
               "segment_phases": phases(seg, ds.SEG_STAMPS[:8], seg[:, 9] > 0),
               "max_rounds": int(seg[:, 10].max()), "max_windows": int(seg[:, 8].max()),
               "ptxas": {"chain_kernel": f"{cframe}; {cused}", "segment_kernel": f"{frame}; {used}"}}
        assert rec["max_rounds"] <= 17, rec["max_rounds"]
        out[label] = rec
        print(f"[stream] decode_stream.cu on {label} ({len(body)} B in, {dst} B out; "
              f"{rec['chunks']} chunks, {rec['visited']} visited; {rec['segments']} segments, "
              f"{rec['waited']} waited on a flag): kernels alone "
              f"{_or_not_measured(rec['kernel_ms'])} {rec['kernels']}, launched "
              f"{rec['launch_ms']:.4f} ms, a call {rec['call_ms']:.4f} ms (CUDA events), a lone "
              f"call {rec['lone_ms']:.4f} ms (host clock); chain {rec['chunk_us']:.3f} us a chunk, "
              f"segments {rec['segment_us']:.3f} us a segment (%globaltimer spans); SM cycles, "
              f"chain_kernel {rec['chain_phases']}, segment_kernel {rec['segment_phases']}; "
              f"resolve rounds <= {rec['max_rounds']}, windows <= {rec['max_windows']}", flush=True)
    print(f"[stream] ptxas -v: chain_kernel {cframe}; {cused}; segment_kernel {frame}; {used}; "
          f"dynamic shared memory a block {ds.smem_bytes(0)} / {ds.smem_bytes(1)} B", flush=True)
    return out


def _scan_phase(torch, np, dev, golden: bytes, ulen: int, big_comp: bytes, big_len: int) -> dict:
    """Phase 6's measurements of ``scan_segments.cu`` on urls.10K.snappy and
    the 16 MiB stream: the kernel alone (torch.profiler), its launch (CUDA
    events), a lone call and the host scan (host clock), the stamped phases
    of the slowest block and the chaining's span (%globaltimer), the sweep
    over ``CHUNK_LOGS``, and ``decode_ws`` (host clock, its device kernels);
    then a stream of the 16 MiB one's input length whose tag chains never
    merge, exact against the plain walk and timed; ``ptxas -v`` and shared
    memory.  Returns a record for each stream and one shared."""
    from csnappy_tpu_torch.models import wire
    from csnappy_tpu_torch.ops import decode_ws
    from csnappy_tpu_torch.runtime import native
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    def u8(b: bytes):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8)

    def launch_ms(bdev, nslot: int, log: int, n: int = 20) -> float:
        seg = torch.empty(nslot, dtype=torch.int32, device=dev)
        meta = torch.empty(4, dtype=torch.int64, device=dev)
        return time_ms(lambda: decode_ws._launch(bdev, seg, meta, chunk_log=log), n=n)

    out = {}
    for label, stream, dst in (("702KB", golden, ulen), ("16MiB", big_comp, big_len)):
        body = stream[wire.varint_decode(stream)[1]:]
        bdev = u8(body).to(dev)
        nseg = -(-dst // decode_ws.SEG)
        n = 10 if label == "16MiB" else 20
        st = torch.zeros((decode_ws.chunks(len(body)), decode_ws.STAMPS), dtype=torch.int64,
                         device=dev)
        seg = torch.empty(nseg + 1, dtype=torch.int32, device=dev)
        meta = torch.empty(4, dtype=torch.int64, device=dev)
        decode_ws._launch(bdev, seg, meta, stamps=st)
        pseg, pmeta = decode_ws.scan_plain(u8(body), nseg + 1)
        assert torch.equal(seg.cpu(), pseg) and torch.equal(meta[:3].cpu(), pmeta[:3]), label
        stamps = st.cpu().numpy()
        phases = stamps[:, : len(decode_ws.PHASES)]
        slow = int(np.argmax(phases.sum(1)))
        counts = dict(zip(decode_ws.COUNTS, stamps[:, len(decode_ws.PHASES):].T))
        visited = counts["visited"] == 1
        ns = counts["published_ns"][visited]
        kernels = device_profile(lambda: decode_ws.scan_segments(bdev, nseg + 1, dev), 10)
        ws_kernels = _device_kernels(
            torch, lambda: decode_ws.decompress_noheader_ws(bdev, dst, dev), f"decode_ws {label}")
        assert sorted(ws_kernels.values()) == [1, 1], ws_kernels
        rec = {"chunks": len(stamps), "chunk_log": decode_ws.CHUNK_LOG,
               "visited": int(visited.sum()), "meta3": int(meta[3]),
               "kernel_ms": kernels["device_ms"] or None,
               "launch_ms": launch_ms(bdev, nseg + 1, decode_ws.CHUNK_LOG, n),
               "lone_ms": _lone_ms(torch, lambda: decode_ws.scan_segments(bdev, nseg + 1, dev), n),
               "host_scan_ms": statistics.median(
                   _host_ms(lambda: native.scan_segments(body, dst, decode_ws.SEG))
                   for _ in range(5)),
               "decode_ws_ms": statistics.median(
                   _host_ms(lambda: decode_ws.decompress_noheader_ws(bdev, dst, dev))
                   for _ in range(5)),
               "decode_ws_kernels": ws_kernels,
               "chaining_us": float(ns.max() - ns.min()) / 1e3 if len(ns) > 1 else 0.0,
               "slowest_block": {"chunk": slow, "cycles": int(phases[slow].sum()),
                                 "phases": dict(zip(decode_ws.PHASES, phases[slow].tolist())),
                                 "rounds": int(counts["rounds"][slow])},
               "median_block_phases": dict(zip(decode_ws.PHASES,
                                               np.median(phases[visited], 0).tolist())),
               "sweep_launch_ms": {2 ** log: launch_ms(bdev, nseg + 1, log, n)
                                   for log in decode_ws.CHUNK_LOGS}}
        rec["hop_us"] = rec["chaining_us"] / max(1, rec["visited"] - 1)
        out[label] = rec
        print(f"[scan] {label}: {rec['chunks']} chunks of {2 ** decode_ws.CHUNK_LOG} positions, "
              f"{rec['visited']} visited; kernel alone {_or_not_measured(rec['kernel_ms'])}, "
              f"launched {rec['launch_ms']:.4f} ms (CUDA events, with the workspace memset), a "
              f"lone scan_segments call {rec['lone_ms']:.4f} ms, host scan "
              f"{rec['host_scan_ms']:.4f} ms (host clock); chaining {rec['chaining_us']:.1f} us "
              f"from chunk 0's publish to the stop's ({rec['hop_us']:.3f} us a chunk); slowest "
              f"block {rec['slowest_block']}; median visited block (SM cycles) "
              f"{rec['median_block_phases']}; chunk sweep, launched ms {rec['sweep_launch_ms']}; "
              f"decode_ws {rec['decode_ws_ms']:.4f} ms host clock, device kernels a call "
              f"{ws_kernels}", flush=True)
    # the worst case: two tag chains that never merge, at the 16 MiB stream's input length
    blen = len(big_comp) - wire.varint_decode(big_comp)[1]
    never = b"\x00a" + b"\x01\x01" * ((blen - 2) // 2)
    nseg = -(-(1 + 2 * (len(never) - 2)) // decode_ws.SEG)
    ndev = u8(never).to(dev)
    seg, meta = decode_ws.scan_segments(ndev, nseg + 1, dev)
    pseg, pmeta = decode_ws.scan_plain(u8(never), nseg + 1)
    assert torch.equal(seg.cpu(), pseg) and torch.equal(meta[:3].cpu(), pmeta[:3]), "never-merging"
    assert int(meta[3]) == decode_ws.chunks(len(never)), int(meta[3])    # every chunk visited
    never_ms = launch_ms(ndev, nseg + 1, decode_ws.CHUNK_LOG, 10)
    never_kernel = device_profile(lambda: decode_ws.scan_segments(ndev, nseg + 1, dev), 5)
    frame, used = _ptxas(f"scan_kernelILi{decode_ws.CHUNK_LOG}E", "scan_segments")
    smem = {2 ** log: decode_ws.smem_bytes(log) for log in decode_ws.CHUNK_LOGS}
    out["shared"] = {"never_merging_bytes": len(never), "never_merging_launch_ms": never_ms,
                     "never_merging_kernel_ms": never_kernel["device_ms"] or None,
                     "never_merging_chunks_visited": int(meta[3]),
                     "ptxas": f"{frame}; {used}", "smem_bytes_by_chunk": smem,
                     "workspace_bytes_per_position": 8 / 2 ** decode_ws.CHUNK_LOG}
    print(f"[scan] never-merging stream of {len(never)} B (the 16 MiB stream's input length; "
          f"{int(meta[3])} chunks visited, exact against the plain walk): launched "
          f"{never_ms:.4f} ms, kernel alone {_or_not_measured(never_kernel['device_ms'] or None)}, "
          f"against {out['16MiB']['launch_ms']:.4f} ms on the 16 MiB stream; scan_kernel<"
          f"{decode_ws.CHUNK_LOG}> ptxas -v: {frame}; {used}; dynamic shared memory a block by "
          f"chunk size {smem} B; workspace 16 B + 8 B a chunk", flush=True)
    return out


ZRAM_BYTES = 256 << 20         # the [container] tree: 65,536 pages of 4 KiB
PAGE = 4096


def _container(torch, np, dev, card: str) -> dict:
    """Phase 7: ``zramsim.run`` over a 256 MiB tree of 4 KiB pages on the
    card with md5 readback; the first 64 pages of each corpus file equal to
    the plain versions; every stored page checked with the host decoder;
    the zram record.  Returns the container path's launch counts."""
    import tempfile

    from csnappy_tpu_torch.ops import decode_fused, encode_fused
    from csnappy_tpu_torch.runtime import container, native
    from csnappy_tpu_torch.tools import zramsim

    seen, stats = [], {"c": [], "d": []}
    compress, decompress = container.compress_blocks, container.decompress_blocks

    def compress_seen(data, *a, **k):
        cont, st = compress(data, *a, **k)
        seen.append((data, cont))
        stats["c"].append(st)
        return cont, st

    def decompress_seen(*a, **k):
        out, st = decompress(*a, **k)
        stats["d"].append(st)
        return out, st

    with tempfile.TemporaryDirectory(prefix="zram_tree_") as root:
        names = zramsim.corpus_tree(root, ZRAM_BYTES)
        assert "urls.10K" in names, "corpus without tests/data/urls.10K"
        wrappers = {"encode_blocks": encode_fused.encode_blocks,
                    "decode_blocks": decode_fused.decode_blocks}
        container.compress_blocks, container.decompress_blocks = compress_seen, decompress_seen
        try:
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            rec = zramsim.run(root, page_size=PAGE)           # device=None: the card
            wall = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
        finally:
            container.compress_blocks, container.decompress_blocks = compress, decompress
    assert rec["orig_data_size"] == ZRAM_BYTES and all(n > 0 for n in launches.values()), \
        (rec, launches)

    # the first 64 pages of each corpus file: card container == plain versions'
    first = {}
    for data, cont in seen:                     # one file of each corpus member
        first.setdefault(data[: 64 * PAGE], (data, cont))
    n_plain = 0
    for data, cont in first.values():
        head = data[: 64 * PAGE]
        plain, _ = container.compress_blocks(head, PAGE, device="cpu")
        k = (len(head) + PAGE - 1) // PAGE
        table = np.frombuffer(cont, "<u4", count=k, offset=4)
        stored = (table & ~np.uint32(container.RAW_BIT)).astype(np.int64)
        start = 4 + 4 * int(np.frombuffer(cont, "<u4", count=1)[0])
        want = (np.array([k], "<u4").tobytes() + table.tobytes()
                + cont[start : start + int(stored.sum())])
        assert plain == want, f"container of a {len(data)}-byte file differs from plain"
        n_plain += k

    # every stored page, through the port's host decoder
    pages = comp_pages = 0
    for data, cont in seen:
        nr = int(np.frombuffer(cont, "<u4", count=1)[0])
        table = np.frombuffer(cont, "<u4", count=nr, offset=4)
        raw = (table == PAGE) | (table & container.RAW_BIT > 0)
        lens = (table & ~np.uint32(container.RAW_BIT)).astype(np.int64)
        offs = 4 + 4 * nr + np.concatenate([[0], np.cumsum(lens)])
        for i in range(nr):
            page = data[i * PAGE : (i + 1) * PAGE]
            body = cont[offs[i] : offs[i + 1]]
            got = body if raw[i] else native.decompress_noheader(body, len(page))
            assert got == page, f"page {i} of a {len(data)}-byte file"
        pages += nr
        comp_pages += int((~raw).sum())
    t0 = time.perf_counter()                    # zramsim hashes each file twice
    for data, _ in seen:
        hashlib.md5(data).hexdigest()
    md5_s = 2 * (time.perf_counter() - t0)
    c_s = sum(st.codec_seconds for st in stats["c"])
    d_s = sum(st.codec_seconds for st in stats["d"])
    hist = [sum(st.histogram[j] for st in stats["c"]) for j in range(3)]
    record = dict(rec, nr_pages=pages, page_size=PAGE, compressed_pages=comp_pages,
                  histogram=hist, codec_seconds_compress=c_s, codec_seconds_decompress=d_s,
                  compress_GBps=ZRAM_BYTES / c_s / 1e9, decompress_GBps=ZRAM_BYTES / d_s / 1e9,
                  host_seconds=rec["wall_seconds"] - rec["codec_seconds"], md5_seconds=md5_s,
                  wall_seconds_with_hooks=wall, launches=launches, card=card)
    print(f"[container] zramsim over {rec['nr_files']} files, {ZRAM_BYTES} B, {pages} pages of "
          f"{PAGE} B on the card: md5 readback of every file; {n_plain} pages equal to the "
          f"plain versions; all {pages} stored pages ({comp_pages} compressed) decode through "
          f"native.decompress_noheader to their input; launches {launches}", flush=True)
    print(json.dumps({"zram": record}), flush=True)
    return launches


def _container_fixture(np, dev) -> None:
    """Phase 8: the port's container equals the JAX fixture
    (``tests/data/torch_ref/container.npz``) byte for byte, stats and error
    codes included, on the card."""
    from csnappy_tpu_torch.errors import SnappyError
    from csnappy_tpu_torch.runtime import container

    z = np.load(DATA / "torch_ref" / "container.npz")
    for i, name in enumerate(str(s) for s in z["names"]):
        data = z["data"][z["data_offs"][i] : z["data_offs"][i + 1]].tobytes()
        want = z["cont"][z["cont_offs"][i] : z["cont_offs"][i + 1]].tobytes()
        page = int(z["page_size"][i])
        cont, sc = container.compress_blocks(data, page, device=dev)
        assert cont == want, name
        out, sd = container.decompress_blocks(cont, page, device=dev)
        assert out == data, name
        for st, key in ((sc, "stats_c"), (sd, "stats_d")):
            got = [st.nr_pages, st.bytes_in, st.bytes_out, *st.histogram]
            assert got == z[key][i].tolist(), (name, key, got)
    codes = []
    for i, name in enumerate(str(s) for s in z["bad_names"]):
        cont = z["bad_cont"][z["bad_offs"][i] : z["bad_offs"][i + 1]].tobytes()
        try:
            container.decompress_blocks(cont, int(z["bad_page_size"][i]), device=dev)
            code = 0
        except SnappyError as e:
            code = e.code
        assert code == int(z["bad_code"][i]), (name, code)
        codes.append(code)
    print(f"[container-fixture] {len(z['names'])} containers byte-identical to the JAX "
          f"fixture with equal stats; {len(codes)} malformed containers give its codes "
          f"{codes}", flush=True)


def _cli(urls: bytes, golden: bytes, fixture: bytes) -> None:
    """Phase 9: ``python -m csnappy_tpu_torch.cli`` in subprocesses on the
    card, in two waves of parallel processes."""
    import os
    import tempfile

    from csnappy_tpu_torch.runtime import container

    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        t = pathlib.Path(tmp)
        src = DATA / "urls.10K"

        def run(wave):
            procs = {name: (subprocess.Popen(
                [sys.executable, "-m", "csnappy_tpu_torch.cli", *args], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE), time.perf_counter())
                for name, args in wave.items()}
            for name, (p, t0) in procs.items():
                out, err = p.communicate(timeout=300)
                dt = time.perf_counter() - t0
                assert p.returncode == 0, (name, p.returncode, err.decode()[-2000:])
                print(f"[cli] {name}: exit 0 in {dt:.1f} s; {err.decode().strip()}", flush=True)

        run({"file -c": ["file", "-c", str(src), str(t / "u.snappy")],
             "file -d golden": ["file", "-d", str(DATA / "urls.10K.snappy"), str(t / "g.out")],
             "file -S c": ["file", "-S", "c"],
             "file -S d": ["file", "-S", "d"],
             "block -c": ["block", "-c", "-p", str(PAGE), str(src), str(t / "u.blk")]})
        run({"file -d": ["file", "-d", str(t / "u.snappy"), str(t / "u.out")],
             "block -d": ["block", "-d", "-p", str(PAGE), str(t / "u.blk"), str(t / "u.blkout")]})
        assert (t / "u.snappy").read_bytes() == fixture
        assert (t / "u.out").read_bytes() == urls and (t / "g.out").read_bytes() == urls
        assert (t / "u.blk").read_bytes() == container.compress_blocks(urls, PAGE, device="cuda")[0]
        assert (t / "u.blkout").read_bytes() == urls
    print("[cli] file -c equal to the JAX fixture stream, file -d and -d of the golden stream "
          "equal to urls.10K, selftests passed, block -c equal to the in-process container "
          "and block -d equal to urls.10K", flush=True)


def _or_not_measured(ms) -> str:
    """A device time from torch.profiler, or why there is none."""
    return "not measured (no device time in the trace)" if ms is None else f"{ms:.4f} ms"


def _one_kernel(name: str, calls: dict, scan: bool, moved: dict) -> str:
    """Assert the device operations of one call (``device_profile``'s
    ``calls``, a count a call): one kernel, once, no copy, and a memset only
    for the scan (at most one), and the wrappers' own counts of one call
    (``moved``) in agreement (``_agree``); return them as text."""
    kernels = {k: c for k, c in calls.items() if not k.startswith(("Memset", "Memcpy"))}
    memsets = sum(c for k, c in calls.items() if k.startswith("Memset"))
    assert len(kernels) == 1 and next(iter(kernels.values())) == 1, (name, calls)
    assert not any(k.startswith("Memcpy") for k in calls), (name, calls)
    assert memsets <= (1.0 if scan else 0.0), (name, calls)
    return "; ".join(f"{k.replace('(anonymous namespace)::', '').split('(')[0]} x{c:g}"
                     for k, c in calls.items()) + f" ({_agree(name, calls, moved)[0]})"


def _new_ptxas() -> dict:
    """``ptxas -v`` of the one-launch gather and scan kernels (``lane_gather_kernel`` and
    ``lane_gather_staged_kernel`` of ``csrc/primitives.cu``, ``scan_kernel``
    of ``csrc/movebench.cu``), each asserted free of stack and spills."""
    from csnappy_tpu_torch.ops import _build

    _build.build(("primitives", "movebench"))                 # the logs of their builds
    out = {}
    for kernel, lib in (("lane_gather_kernel", "primitives"),
                        ("lane_gather_staged_kernel", "primitives"), ("scan_kernel", "movebench")):
        frame, used = _ptxas(kernel, lib)
        assert frame.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"), \
            (kernel, frame)
        out[kernel] = f"{used}; {frame}"
    return out


def _movebench(torch, np, dev, card: str) -> list:
    """Phase 10: rows 12-13 (``lane_gather`` of ``csrc/primitives.cu`` and
    the scan of ``csrc/movebench.cu``) against their plain
    versions at n = 32768 and 2^24 with 0 differing elements, timed beside
    the library call and the bound, each call's device operations asserted
    (one kernel; the scan one kernel and at most one memset); at 2^24 the
    gather also on sorted indices and on a 2^22-entry table (the floor its
    random reads set); then ``movebench.main()`` with launch counts set to
    0."""
    from csnappy_tpu_torch.tools import movebench as mb
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    for kernel, line in _new_ptxas().items():
        print(f"[movebench] ptxas -v {kernel}: {line}", flush=True)
    rows = {}
    for n in (32768, 1 << 24):
        tbl, idx = mb.inputs(n, dev)
        x = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 31, (n // 128, 128),
                                                                dtype=np.int32)).to(dev)
        tc, ic, xc = tbl.cpu(), idx.cpu(), x.cpu()
        got_g, got_s = mb.gather_flat(tbl, idx, 16, dev), mb.scan_max(x, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_g = mb.gather_flat(tc, ic, 16, "cpu")
        plain_g = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want_s = mb.scan_max(xc, "cpu")
        plain_s = (time.perf_counter() - t0) * 1e3
        diff = {"gather_flat": int((got_g.cpu() != want_g).sum()),
                "scan_max": int((got_s.cpu() != want_s).sum())}
        err = {"gather_flat": int((got_g.cpu().long() - want_g.long()).abs().max()),
               "scan_max": int((got_s.cpu().long() - want_s.long()).abs().max())}
        assert not any(diff.values()) and not any(err.values()), (n, diff, err)
        ftbl, fidx, fx = tbl.reshape(-1), idx.reshape(-1), x.reshape(-1)
        for name, call, lib_ms, plain, nbytes in (
                ("gather_flat", lambda: mb.gather_flat(tbl, idx, 16, dev),
                 time_ms(lambda: ftbl[fidx]), plain_g, 12 * n),
                ("scan_max", lambda: mb.scan_max(x, dev),
                 time_ms(lambda: torch.cummax(fx, 0)), plain_s, 8 * n)):
            ms, prof = time_ms(call), device_profile(call)
            device_ms = prof["device_ms"] or None
            ops = _one_kernel(name, prof["calls"], name == "scan_max",
                              _wrapper_launches(torch, call))
            bound_ms, bound_by = _bound(nbytes)
            print(f"[movebench] {name} n={n}: {ms:.4f} ms, kernel alone "
                  f"{_or_not_measured(device_ms)}, library {lib_ms:.4f} ms, plain "
                  f"{plain:.2f} ms (host CPU), bound {bound_ms:.5f} ms by {bound_by} "
                  f"({nbytes} B); 0 of {n} elements differ; device ops of a call: {ops}",
                  flush=True)
            if n == 32768:
                rows[name] = {"name": name, "route": "cuda",
                              "source": "csnappy_tpu_torch/csrc/"
                                        + ("primitives.cu" if name == "gather_flat"
                                           else "movebench.cu"),
                              "entry": "lane_gather" if name == "gather_flat" else "scan",
                              "replaces": "csnappy_tpu/tools/movebench.py:"
                                          + ("62" if name == "gather_flat" else "92"),
                              "launches": 0, "max_abs_err": err[name], "ms": ms,
                              "device_ms": device_ms, "plain_ms": plain,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                              "bytes": nbytes, "device_ops": prof["calls"]}
            else:
                rows[name].update(ms_n16M=ms, device_ms_n16M=device_ms, library_ms_n16M=lib_ms,
                                  plain_ms_n16M=plain, bound_ms_n16M=bound_ms)
        if n == 1 << 24:
            # the same kernel where its table reads cost less: indices in order
            # (each 32-byte sector read whole), and random indices into a
            # 2^22-entry table that stays in L2 (each read still a sector)
            floor = {}
            for label, t2, i2 in (("sorted indices", tbl, torch.sort(fidx).values.view_as(idx)),
                                  ("a 2^22-entry table", tbl.reshape(-1)[: 1 << 22].clone(),
                                   torch.remainder(idx, 1 << 22))):
                got = mb.gather_flat(t2, i2, 16, dev)
                want = mb.gather_flat(t2.cpu(), i2.cpu(), 16, "cpu")
                assert torch.equal(got.cpu(), want), label
                floor[label] = device_profile(lambda: mb.gather_flat(t2, i2, 16, dev))["device_ms"]
            rows["gather_flat"]["device_ms_n16M_floors"] = floor
            print(f"[movebench] gather_flat n={n}, the kernel alone where its reads cost less: "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in floor.items())
                  + f" (random reads of a 2^24-entry table: {rows['gather_flat']['device_ms_n16M']:.4f}"
                  f" ms; 2^24 random 4-byte reads touch 2^24 32-byte sectors, 536,870,912 B); "
                  f"card {card}", flush=True)
    mb.gather_flat.launches = mb.scan_max.launches = 0
    assert mb.main([]) == 0                                   # device=None: the card
    for name, w in (("gather_flat", mb.gather_flat), ("scan_max", mb.scan_max)):
        assert w.launches > 0, name
        rows[name]["launches"] = w.launches
    print(f"[movebench] main(): launches gather_flat {mb.gather_flat.launches}, scan_max "
          f"{mb.scan_max.launches}; card {card}", flush=True)
    return list(rows.values())


def _primitives(torch, np, dev, card: str) -> list:
    """Phase 11: rows 6-11 (``csrc/primitives.cu``) through the six wrappers
    of ``ops/primitives.py`` on the main path's batch with launch counts,
    against their plain versions and the JAX fixture, then timed, each
    call's device operations asserted (one kernel) and ``lane_gather``'s
    path printed; then the two ``lane_gather`` kernels beside each other at
    the path rule's switch points, and the host split of one
    ``table_gather`` and one ``scan_max`` call (``tools/torch_profile.py``)."""
    from csnappy_tpu_torch.ops import primitives as prim
    from csnappy_tpu_torch.tools.movebench import primitive_inputs
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    host = {fn: [torch.from_numpy(a) for a in arrs] for fn, arrs in primitive_inputs(B).items()}
    on_card = {fn: [a.to(dev) for a in arrs] for fn, arrs in host.items()}
    torch.cuda.synchronize()
    for p in prim.PRIMITIVES.values():
        p.wrapper.launches = 0
    got = {fn: tup(p.wrapper(*on_card[fn])) for fn, p in prim.PRIMITIVES.items()}  # device=None
    torch.cuda.synchronize()
    launches = {fn: p.wrapper.launches for fn, p in prim.PRIMITIVES.items()}
    assert launches == {fn: 1 for fn in prim.PRIMITIVES}, launches
    print(f"[primitives] main path: the six wrappers on the card at B={B} x 32 KiB, "
          f"launches {launches}", flush=True)

    rows = []
    for fn, (wrapper, _, entry, replaces) in prim.PRIMITIVES.items():
        t0 = time.perf_counter()
        want = tup(wrapper(*host[fn], device="cpu"))
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = sum(int((g.cpu() != w).sum()) for g, w in zip(got[fn], want))
        err = max(int((g.cpu().long() - w.long()).abs().max()) for g, w in zip(got[fn], want))
        assert diff == 0 and err == 0, (fn, diff, err)
        nbytes = 4 * (sum(a.numel() for a in host[fn]) + sum(g.numel() for g in got[fn]))
        bound_ms, bound_by = _bound(nbytes)
        prof = device_profile(lambda: wrapper(*on_card[fn]))
        device_ms = prof["device_ms"] or None
        ops = _one_kernel(fn, prof["calls"], False,
                          _wrapper_launches(torch, lambda: wrapper(*on_card[fn])))
        path = ""
        if entry == "lane_gather":
            src, ix = on_card[fn]
            groups = 1 if fn == "table_gather" else src.numel() // src.shape[-1]
            mode = prim.lane_gather_mode(groups, src.numel() // groups, ix.numel() // groups,
                                         src.data_ptr(), ix.data_ptr())
            path = (f", path {'staged' if mode & prim.STAGED else 'direct'}"
                    f"{', vector indices' if mode & prim.VEC_IDX else ''}"
                    f"{', vector table' if mode & prim.VEC_TABLE else ''} (mode {mode})")
        library, call = None, None
        if fn == "local_scatter_or":
            m, t = on_card[fn]
            idx = t.clamp(0, 127).long()                        # set-up, not timed
            src = torch.where((t >= 0) & (t < 128), m, 0)
            library = "mask.scatter_reduce(-1, idx, src, 'amax', include_self=True)"
            call = lambda: m.scatter_reduce(-1, idx, src, "amax", include_self=True)
            assert torch.equal(call(), got[fn][0]), "the library call differs from the kernel"
        if fn in ("local_gather", "row_gather", "table_gather", "rowwise_gather"):
            src, ix = on_card[fn]
            width = src.shape[-1] if fn in ("local_gather", "rowwise_gather") else src.shape[0]
            ix64 = ix.clamp(0, width - 1).long()
            library, call = {
                "local_gather": ("torch.gather(values, -1, idx)",
                                 lambda: torch.gather(src, -1, ix64)),
                "row_gather": ("torch.index_select(table2d, 0, rows)",
                               lambda: torch.index_select(src, 0, ix64)),
                "table_gather": ("torch.take(table, idx)", lambda: torch.take(src, ix64)),
                "rowwise_gather": ("torch.gather(tables, 1, idx)",
                                   lambda: torch.gather(src, 1, ix64)),
            }[fn]
        # the wrapper and its library call in KL_ROUNDS interleaved rounds
        rounds, lib_rounds = [], []
        for _ in range(KL_ROUNDS):
            rounds.append(time_ms(lambda: wrapper(*on_card[fn])))
            if call is not None:
                lib_rounds.append(time_ms(call))
        ms = statistics.median(rounds)
        lib_ms = statistics.median(lib_rounds) if lib_rounds else None
        shapes = [tuple(a.shape) for a in host[fn]]
        print(f"[primitives] {fn} ({entry}) {shapes}: {ms:.4f} ms (median of {KL_ROUNDS} "
              f"rounds, {min(rounds):.4f}-{max(rounds):.4f}), kernel alone "
              f"{_or_not_measured(device_ms)}, plain {plain_ms:.2f} ms (host "
              f"CPU), bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B), library "
              + (f"{library} {lib_ms:.4f} ms ({min(lib_rounds):.4f}-{max(lib_rounds):.4f}; "
                 f"in-range int64 indices)" if library else "none")
              + f"; 0 of {sum(g.numel() for g in got[fn])} elements differ; device ops of a "
              f"call: {ops}{path}", flush=True)
        rows.append({"name": fn, "route": "cuda", "source": "csnappy_tpu_torch/csrc/primitives.cu",
                     "replaces": replaces, "entry": entry, "launches": launches[fn],
                     "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "library": library,
                     "bytes": nbytes, "device_ops": prof["calls"]})

    z = np.load(DATA / "torch_ref" / "primitives.npz")
    for case, fn, limbs in zip(z["cases"], z["fns"], z["limbs"]):
        case, fn, limbs = str(case), str(fn), int(limbs)
        args = [torch.from_numpy(z[f"{case}__{a}"]).to(dev) for a in prim.PRIMITIVES[fn].args]
        outs = tup(prim.PRIMITIVES[fn].wrapper(*args, **({"limbs": limbs} if limbs else {})))
        torch.cuda.synchronize()
        for k, o in enumerate(outs):
            assert np.array_equal(o.cpu().numpy(), z[f"{case}__out{k}"]), (case, k)
    print(f"[primitives] {len(z['cases'])} fixture cases equal to the JAX Pallas kernels on the "
          f"card (values outside the limbs' contract included); card {card}", flush=True)
    _lane_gather_sweep(torch, np, prim, dev, card)
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_profile",
                                                  ROOT / "tools" / "torch_profile.py")
    tp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tp)
    for name, split in tp.primitive_host_split(torch, dev).items():
        print(f"[primitives] host split of one {name} call (32768 entries; us, "
              f"time.perf_counter_ns, 2000 runs a step): "
              + "; ".join(f"{k} {v:.2f}" for k, v in split.items()) + f"; card {card}",
              flush=True)
    return rows


# (G, W, N) where lane_gather's path rule switches (ops/primitives.lane_gather_mode)
LANE_GATHER_SWEEP = ((1, 32768, 32768), (1, 32768, 131072), (1, 32768, 262144), (1, 32768, 524288),
                     (1, 32768, 1 << 21), (2, 32768, 32768), (4, 32768, 32768),
                     (8, 32768, 32768), (16, 32768, 32768), (64, 32768, 32768),
                     (64, 64, 32768), (64, 127, 32768), (64, 128, 32768), (64, 512, 32768),
                     (64, 4096, 32768), (1, 1024, 1 << 21), (1, 58112, 1 << 21),
                     (1000, 512, 4092), (1000, 512, 4096), (4096, 128, 512), (16384, 128, 128),
                     (8, 58112, 58112), (64, 58112, 32768))


def _lane_gather_sweep(torch, np, prim, dev, card: str) -> None:
    """Each ``lane_gather`` kernel alone (``device_ms``) at the shapes of
    ``LANE_GATHER_SWEEP``, with aligned operands, both paths forced, equal
    to each other, beside the path the rule takes."""
    from csnappy_tpu_torch.tools.timing import device_profile

    rng = np.random.default_rng(15)
    picked = []
    for G, W, N in LANE_GATHER_SWEEP:
        t = torch.from_numpy(rng.integers(0, 1 << 24, G * W, dtype=np.int32)).to(dev)
        i = torch.from_numpy(rng.integers(-3, W + 3, G * N, dtype=np.int32)).to(dev)
        vec = prim.VEC_IDX | (prim.VEC_TABLE if W % 4 == 0 else 0)
        direct, staged = prim.VEC_IDX, prim.STAGED | vec
        a = prim.launch_lane_gather(t, W, i, G, 0xFFFFFFFF, dev, mode=direct)
        b = prim.launch_lane_gather(t, W, i, G, 0xFFFFFFFF, dev, mode=staged)
        assert torch.equal(a, b), (G, W, N)
        ms = [device_profile(lambda m=m: prim.launch_lane_gather(t, W, i, G, 0xFFFFFFFF, dev,
                                                                   mode=m))["device_ms"]
              for m in (direct, staged)]
        rule = prim.lane_gather_mode(G, W, N, t.data_ptr(), i.data_ptr())
        faster = "staged" if ms[1] < ms[0] else "direct"
        took = "staged" if rule & prim.STAGED else "direct"
        picked.append(faster == took)
        print(f"[primitives] lane_gather G={G} W={W} N={N}: kernel alone direct {ms[0]:.5f} ms, "
              f"staged {ms[1]:.5f} ms; faster {faster}, the rule takes {took}", flush=True)
    print(f"[primitives] lane_gather path rule: the faster kernel at {sum(picked)} of "
          f"{len(picked)} sweep shapes; card {card}", flush=True)


def _probes(torch, np, dev, card: str) -> tuple[list, dict]:
    """Phase 12: rows 14a-14i (``csrc/probe.cu``, ``csrc/probe3.cu``, ``csrc/probe4.cu``) through
    ``tools/probe.py`` with launch counts: every probe with a kernel measured on the card and held
    against its plain version and the JAX probes' answers.  Returns one ``kernels`` row per
    ``pl.pallas_call`` site and each probe's measurement."""
    from csnappy_tpu_torch.tools import probe

    # one measurement a kernel: probes that share an entry (mosaic_probe6's
    # four gathers, one function) are measured once, under the first name
    same = {}
    for name in probe.TIMED:
        same.setdefault((probe.PROBES[name].lib, probe.PROBES[name].entry), []).append(name)
    also = {names[0]: names[1:] for names in same.values()}
    for name in probe.PROBES:
        probe.probe.launches[name] = 0
    names = tuple(also) + ("mosaic_probe5.smem_cap",)
    recs = {name: probe.measure(name) for name in names}               # device=None: the card
    torch.cuda.synchronize()
    launches = {name: probe.probe.launches[name] for name in names}
    assert all(n > 0 for n in launches.values()), launches
    bad = [name for name, r in recs.items() if not r["result_equals_plain"]]
    assert not bad, bad
    clocks = probe.clocks()
    for name, r in recs.items():
        if r["ns_per_iter"] is None:
            continue
        print(f"[probes] {name}: {r['ns_per_iter']:.2f} ns, {r['cycles_per_iter']:.2f} SM cycles "
              f"an iteration of {r['steps_per_iter']} step(s) (K {r['k_lo']} -> {r['k_hi']}, "
              f"{r['space']} memory); {r['ms']:.4f} ms at K = {r['k_hi']}, plain "
              f"{r['plain_ms']:.1f} ms (host CPU); {launches[name]} launches"
              + (f"; the same kernel as {', '.join(also[name])}" if also.get(name) else "")
              + (f"; one SM's bound {r['sm_bound_cycles']:.2f} cycles an iteration "
                 f"({probe.SM_OPS_PER_CYCLE[probe.PROBES[name].tensor]} "
                 f"{probe.PROBES[name].tensor} operations a cycle), "
                 f"{100 * r['sm_share']:.1f}% of it reached" if "sm_share" in r else "")
              + f"; the card's bound {r['bound_ms']:.4f} ms at k_hi ({r['bound_by']}), "
                f"{100 * r['bound_share']:.2f}% of it reached"
              + (f"; check words equal the plain version's: {r['words_equal_plain']}"
                 if "words_equal_plain" in r else ""),
              flush=True)
    cap = recs["mosaic_probe5.smem_cap"]
    print(f"[probes] shared-memory capacity of a block: {cap['capacity_bytes']} bytes; (rows, 128) "
          f"int32 scratch runs at rows {cap['rows_ok']}", flush=True)

    z = np.load(DATA / "torch_ref" / "probes.npz")
    ncase = nwords = 0
    for name in probe.TIMED:
        tbl = probe.second_input(name)
        htab = None if tbl is None else torch.from_numpy(tbl)
        tab = None if htab is None else htab.to(dev)
        for key in (k for k in z.files if k.startswith(name + "__")):
            # <name>__k<K> on the probe's own input, <name>__<case>_k<K> on case_<case>
            case, k = key.split("__")[1].rsplit("k", 1)
            host = torch.from_numpy(z["case_" + case[:-1]] if case else probe.inputs(name))
            got = probe.probe(name, int(k), host.to(dev), tab).cpu()
            want = probe.probe(name, int(k), host, htab, device="cpu")
            assert np.array_equal(got.numpy(), z[key]) and torch.equal(got, want), key
            if name in probe.WORDS:         # what the int32 output hides, held exactly
                got = probe.words(name, int(k), host.to(dev), tab).cpu()
                assert torch.equal(got, probe.words(name, int(k), host, htab, device="cpu")), key
                nwords += 1
            ncase += 1
    rand = torch.from_numpy(z["case_p4rand"])
    wrapped = []
    for name in (n for n in probe.TIMED if n.startswith("mosaic_probe4.gather_r")):
        got = probe.probe(name, probe.WRAP_K, rand.to(dev)).cpu()
        want = probe.probe(name, probe.WRAP_K, rand, device="cpu")
        assert torch.equal(got, want), name
        wrapped += [int(want[0, 0])] if name.endswith("_l2") else []
    assert all(v < 0 for v in wrapped), wrapped
    print(f"[probes] {ncase} fixture cases equal to the JAX probes and to the plain versions on "
          f"the card, {nwords} of them also in their check words ({', '.join(probe.WORDS)}; at "
          f"k_hi too); the 12 resolve-phase gathers at K = {probe.WRAP_K} on case_p4rand equal to "
          f"the plain versions past the int32 wrap of their sum (16-bit answers {wrapped}); card "
          f"{card}; SM clock {clocks['clocks.sm']} (max {clocks['clocks.max.sm']})", flush=True)

    rows = []
    for call, site in probe.SITES.items():
        names = [n for n in recs if probe.PROBES[n].call == call]
        sub = [{k: recs[n][k] for k in ("probe", "ns_per_iter", "cycles_per_iter", "ms", "k_lo",
                                        "k_hi", "steps_per_iter", "space", "plain_ms", "bound_ms")}
               | {k: recs[n][k] for k in ("sm_bound_cycles", "sm_share", "words_equal_plain")
                  if k in recs[n]}
               | {"launches": launches[n], "same_kernel_as": also.get(n, [])} for n in names]
        sub += [{"probe": n, "fails_to_trace_in_jax": p.fails, "kernel": None}
                for n, p in probe.PROBES.items() if p.call == call and p.fails]
        top = max(names, key=lambda n: recs[n]["bound_ms"])
        row = {"name": f"probe:{site}", "route": "cuda",
               "source": f"csnappy_tpu_torch/csrc/{probe.PROBES[top].lib}.cu", "replaces": call,
               "launches": sum(launches[n] for n in names),
               "max_abs_err": max(recs[n]["max_abs_err"] for n in names),
               "ms": sum(recs[n]["ms"] for n in names),
               "plain_ms": sum(recs[n]["plain_ms"] for n in names),
               "bound_ms": sum(recs[n]["bound_ms"] for n in names),
               "bound_by": recs[top]["bound_by"], "library_ms": None, "probes": sub,
               "clocks_sm": clocks["clocks.sm"]}
        if site.endswith("smem_cap"):
            row.update(capacity_bytes=cap["capacity_bytes"], rows_ok=cap["rows_ok"])
        rows.append(row)
    return rows, recs


def _kernel_lib(torch, np, dev, card: str) -> list:
    """Phase 13: rows 15a-15b (``csrc/kernel_lib.cu``) through the helpers of
    ``ops/kernel_lib.py`` with launch counts: every fixture case on the card,
    held against the JAX helpers' answers and the plain versions; a call of
    each helper and of its PyTorch counterpart timed in ``KL_ROUNDS``
    interleaved rounds (the median of 20 calls a round), the median round
    kept with its spread.  Returns the two ``kernels`` rows."""
    from csnappy_tpu_torch.ops import kernel_lib as kl
    from csnappy_tpu_torch.tools.timing import (HBM_BYTES_PER_S, OPS_PER_S, device_profile,
                                                time_ms)

    cases = kl.read_cases(DATA / "torch_ref" / "kernel_lib.npz")
    on_card = {c[0]: {k: torch.from_numpy(v).to(dev) for k, v in c[2].items()} for c in cases}
    torch.cuda.synchronize()
    for name in kl.launches:
        kl.launches[name] = 0
    got, case_launches = {}, {}
    for case, helper, _, params, _ in cases:
        before = kl.launches[helper]
        got[case] = kl.call(helper, on_card[case], params)          # device=None: the card
        case_launches[case] = kl.launches[helper] - before
    torch.cuda.synchronize()
    launches = dict(kl.launches)
    assert launches == {h: sum(c[1] == h for c in cases) for h in kl.HELPERS}, launches
    err = dict.fromkeys(kl.HELPERS, 0)
    for case, helper, arrays, params, outs in cases:
        want = kl.call(helper, {k: torch.from_numpy(v) for k, v in arrays.items()}, params,
                       device="cpu")
        assert len(got[case]) == len(outs) == len(want), case
        for g, o, w in zip(got[case], outs, want):
            g = g.cpu()
            assert np.array_equal(g.numpy(), o) and torch.equal(g, w), case
            err[helper] = max(err[helper], int((g.long() - w.long()).abs().max()))
    print(f"[kernel_lib] main path: the {len(kl.HELPERS)} helpers on the card on the "
          f"{len(cases)} cases of kernel_lib.npz (the 35 of tests/test_kernel_lib.py, answers "
          f"outside the contracts, the helpers no JAX test runs), equal to the JAX helpers and "
          f"the plain versions; launches {launches}", flush=True)


    first = {helper: next(c for c in cases if c[1] == helper) for helper in kl.HELPERS}
    libs = {helper: _library(torch, kl, helper, on_card[c[0]], c[3])
            for helper, c in first.items()}
    # scatter_rows_multi's yardstick is the stacked tables' index_add_ over rows
    # r0..r0+nrows-1 (_index_add); the one table's index_add_ over the whole
    # position tile, which earlier runs divided by, is timed beside it
    srm_case, _, _, srm_params, _ = first["scatter_rows_multi"]
    tile_name, tile_add = _tile_index_add(torch, *list(on_card[srm_case].values())[:2],
                                          128 * srm_params["out_rows"])
    tile_ms = []
    call_ms = {helper: [] for helper in kl.HELPERS}
    lib_ms = {helper: [] for helper in kl.HELPERS}
    plain_ms = {helper: [] for helper in kl.HELPERS}
    for _ in range(KL_ROUNDS):          # interleaved: a slow spell hits every helper
        for helper, (case, _, arrays, params, _) in first.items():
            call_ms[helper].append(time_ms(lambda: kl.call(helper, on_card[case], params)))
            if libs[helper][1] is not None:
                lib_ms[helper].append(time_ms(libs[helper][1]))
            if helper == "scatter_rows_multi":
                tile_ms.append(time_ms(tile_add))
            host = {k: torch.from_numpy(v) for k, v in arrays.items()}
            t0 = time.perf_counter()
            kl.call(helper, host, params, device="cpu")
            plain_ms[helper].append((time.perf_counter() - t0) * 1e3)

    subs = {"15a": [], "15b": []}
    for helper, h in kl.HELPERS.items():
        case, _, arrays, params, _ = first[helper]
        a = on_card[case]
        device_ms = device_profile(lambda: kl.call(helper, a, params))["device_ms"] or None
        nbytes, nops = kl.traffic(helper, arrays, params)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
        ms, lib_name = statistics.median(call_ms[helper]), libs[helper][0]
        lms = statistics.median(lib_ms[helper]) if lib_ms[helper] else None
        shapes = [list(v.shape) for v in arrays.values()]
        subs[h.row].append({"helper": helper, "kind": h.kind, "jax": h.jax, "test": h.test,
                            "case": case, "shapes": shapes,
                            "launches": launches[helper], "max_abs_err": err[helper], "ms": ms,
                            "ms_rounds": call_ms[helper], "device_ms": device_ms,
                            "plain_ms": statistics.median(plain_ms[helper]),
                            "bound_ms": max(bytes_ms, ops_ms), "bound_bytes": nbytes,
                            "bound_ops": nops,
                            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                            "library": lib_name, "library_ms": lms,
                            "library_ms_rounds": lib_ms[helper] or None})
        if helper == "scatter_rows_multi":
            subs[h.row][-1].update(library_one_table=tile_name,
                                   library_one_table_ms=statistics.median(tile_ms))
        print(f"[kernel_lib] {helper} ({h.kind}) on {case} {shapes}: {ms:.4f} ms a call (median "
              f"of {KL_ROUNDS} rounds, {min(call_ms[helper]):.4f}-{max(call_ms[helper]):.4f}), "
              f"kernel alone {_or_not_measured(device_ms)}, plain "
              f"{statistics.median(plain_ms[helper]):.2f} ms (host CPU), bound "
              f"{max(bytes_ms, ops_ms):.7f} ms ({nbytes} B, {nops} operations), library "
              + (f"{lib_name} {lms:.4f} ms ({min(lib_ms[helper]):.4f}-"
                 f"{max(lib_ms[helper]):.4f})" if lms is not None else "none")
              + f"; {launches[helper]} launches", flush=True)
    print(f"[kernel_lib] scatter_rows_multi on {srm_case}: {tile_name} "
          f"{statistics.median(tile_ms):.4f} ms ({min(tile_ms):.4f}-{max(tile_ms):.4f})",
          flush=True)
    by_case = {c[0]: c for c in cases}
    shapes = {helper: _main_shapes(torch, kl, helper, {c: by_case[c] for c in main}, on_card,
                                   case_launches, card)
              for helper, main in (("scatter_rows_multi", MAIN_SCATTERS),
                                   ("gather_rows_multi", MAIN_GATHERS))}
    sites = _call_sites(torch, kl, by_case, on_card, case_launches, card)
    wide = _wide_tile(torch, np, kl, dev, card)
    split = {helper: _host_split(torch, kl, helper, on_card[case], by_case[case][3])
             for helper, case in (("scatter_rows_multi", MAIN_SCATTERS[0]),
                                  ("scatter_sum_tile", first["scatter_sum_tile"][0]),
                                  ("gather_rows_multi", MAIN_GATHERS[0]),
                                  ("lane_gather", first["lane_gather"][0]))}
    rows = []
    for row, name, replaces in (
            ("15a", "kernel_lib:test_kernel_lib._run", "tests/test_kernel_lib.py:16"),
            ("15b", "kernel_lib:test_kernel_lib.gather_rows_multi",
             "tests/test_kernel_lib.py:137")):
        sub = subs[row]
        # one PyTorch call for the row: only where the row is one helper (15b)
        library_ms = sub[0]["library_ms"] if len(sub) == 1 else None
        rows.append({"name": name, "route": "cuda",
                     "source": "csnappy_tpu_torch/csrc/kernel_lib.cu", "replaces": replaces,
                     "launches": sum(r["launches"] for r in sub),
                     "max_abs_err": max(r["max_abs_err"] for r in sub),
                     "ms": sum(r["ms"] for r in sub), "plain_ms": sum(r["plain_ms"] for r in sub),
                     "bound_ms": sum(r["bound_ms"] for r in sub),
                     "bound_by": max(sub, key=lambda r: r["bound_ms"])["bound_by"],
                     "library_ms": library_ms, "helpers": sub})
    rows[0].update(call_sites=sites, wide_tile=wide,
                   scatter_main_shapes=shapes["scatter_rows_multi"],
                   scatter_host_split={h: split[h] for h in ("scatter_rows_multi",
                                                             "scatter_sum_tile")})
    rows[1].update(gather_main_shapes=shapes["gather_rows_multi"],
                   gather_host_split={h: split[h] for h in ("gather_rows_multi", "lane_gather")})
    print(f"[kernel_lib] card {card}", flush=True)
    return rows


def _library(torch, kl, helper: str, a: dict, params: dict):
    """One PyTorch call computing ``helper`` on the arrays ``a`` inside its
    contract: (its name, a function), or (None, None)."""
    x = next(iter(a.values()))
    d, k = params.get("d", 0), params.get("k", 0) % 128
    flat = x.reshape(-1)
    pad = torch.nn.functional.pad
    calls = {
        "stream_shift_down": ("F.pad(x.flat[:n - d], (d, 0), value=fill)",
                              lambda: pad(flat[: flat.numel() - d], (d, 0),
                                          value=params.get("fill", 0))),
        "stream_shift_up": ("F.pad(x.flat[d:], (0, d), value=fill)",
                            lambda: pad(flat[d:], (0, d), value=params.get("fill", 0))),
        "stream_shift_up_mm": ("F.pad(x.flat[d:], (0, d))", lambda: pad(flat[d:], (0, d))),
        "stream_shift_down_mm": ("F.pad(x.flat[:n - d], (d, 0))",
                                 lambda: pad(flat[: flat.numel() - d], (d, 0))),
        "lane_shift_down": ("F.pad(x[:, :128 - k], (k, 0))",
                            lambda: pad(x[:, : 128 - k], (k, 0))),
        "lane_shift_up": ("F.pad(x[:, k:], (0, k))", lambda: pad(x[:, k:], (0, k))),
        "row_shift_down": ("F.pad(x[:R - k], (0, 0, k, 0), value=fill)",
                           lambda: pad(x[: max(x.shape[0] - k, 0)],
                                       (0, 0, min(k, x.shape[0]), 0),
                                       value=params.get("fill", 0))),
        "row_shift_up": ("F.pad(x[k:], (0, 0, 0, k), value=fill)",
                         lambda: pad(x[k:], (0, 0, 0, min(k, x.shape[0])),
                                     value=params.get("fill", 0))),
        "scan2d": ("torch.cummax / torch.cumsum of x.flat", lambda: torch.cummax(flat, 0)
                   if params["op"] == "max" else torch.cumsum(flat, 0, dtype=torch.int32)),
        "scan2d_mm": ("torch.cummax / torch.cumsum of x.flat", lambda: torch.cummax(flat, 0)
                      if params["op"] == "max" else torch.cumsum(flat, 0, dtype=torch.int32)),
        "scan2d_tril": ("torch.cumsum(x.flat)",
                        lambda: torch.cumsum(flat, 0, dtype=torch.int32)),
        "flip2d": ("torch.flip(x.flat, (0,))", lambda: torch.flip(flat, (0,))),
    }
    if helper in ("gather_flat", "local_gather_rows", "lane_gather"):
        tbl, ix = a.values()
        ix64 = ix.long().clamp(0, (tbl.numel() if helper == "gather_flat" else 128) - 1)
        calls[helper] = (("torch.take(table, idx)", lambda: torch.take(tbl, ix64))
                         if helper == "gather_flat" else
                         ("torch.gather(x, 1, idx)", lambda: torch.gather(tbl, 1, ix64)))
    if helper == "gather_rows_multi":
        calls[helper] = _index_select(torch, a, params)
    if helper == "scatter_rows_multi":
        calls[helper] = _index_add(torch, kl, a, params)
    if helper == "scatter_sum_tile":
        pos, val, mask = a.values()
        calls[helper] = _tile_index_add(torch, pos, val, 128 * params["out_rows"], mask != 0)
    return calls.get(helper, (None, None))


# scatter_rows_multi at the shapes of csnappy_tpu/ops/decode_fused.py:470,
# decode_stream.py:315 and encode_fused.py:375, gather_rows_multi at those of
# decode_fused.py:387, decode_stream.py:255 and :270, then with clipped
# indices (fixture cases of kernel_lib.npz)
MAIN_SCATTERS = ("srm_dec_co256", "srm_stream_co256_t3", "srm_enc_ocr304_t3")
MAIN_GATHERS = ("grm_dec_ci256_t8", "grm_stream_r1664_t2", "grm_stream_r1664_t1", "grm_r1664_clip")


# the shifts and scans at the JAX fused kernels' tiles (fixture cases of
# kernel_lib.npz, tools/make_torch_fixtures.py _kernel_lib_call_sites) and
# the call site of each
CALL_SITES = {
    "ssumm_dec_ci512_d1": "decode_fused.py:200-203, P = 65,536",
    "ssumm_dadv_ci2048_d4": "decode_fused.py:200-203, P = 262,144 (dadv)",
    "ssumm_stream_r1664_d2": "decode_stream.py:116-119, WINR",
    "rsu_dec_ci512": "decode_fused.py:245, :253, :254, :272, P = 65,536",
    "rsu_dadv_ci2048": "decode_fused.py:245, :253, :254, :272, P = 262,144 (dadv)",
    "tril_dadv_tr528": "decode_fused.py:424, TROWS at P = 262,144",
    "scanmm_stream_addsat_tr256": "decode_stream.py:282",
    "fmr_dec_co256_b31": "decode_fused.py:494",
    "fmr_dec_co256_b18": "decode_fused.py:495",
    "fmr_stream_co256_b31": "decode_stream.py:330-332",
    "fmr_enc_ocr304_b31": "encode_fused.py:394-396",
    "scanmm_addsat_order_tr256": "decode_stream.py:282's tile outside the contract",
}
# the cases inside their helper's contract where no mask or saturation
# bites on the data (bytes, advances under 2^16, sums under 2^23), so that
# one PyTorch call (_library) computes the same answer
SITE_LIBRARY = ("ssumm_dec_ci512_d1", "ssumm_dadv_ci2048_d4", "ssumm_stream_r1664_d2",
                "rsu_dec_ci512", "rsu_dadv_ci2048", "tril_dadv_tr528",
                "scanmm_stream_addsat_tr256")


def _call_sites(torch, kl, by_case: dict, on_card: dict, case_launches: dict, card: str) -> list:
    """Each shift and scan at its JAX call site's tile (``CALL_SITES``): a
    call timed in ``KL_ROUNDS`` interleaved rounds beside its PyTorch call
    (``_library`` on the ``SITE_LIBRARY`` cases, asserted equal to the
    helper's answer; none for ``fill_max_rows`` and the case outside the
    contract), the kernels alone (``device_ms``) and a call's kernels from
    a bracketed trace (asserted equal to one for a shift, to what the entry
    reports for a scan, where the trace holds device records: after
    ``device_profile``'s retakes a trace without them leaves the count not
    measured), the bound (``kernel_lib.traffic`` bytes over 3.35 TB/s) and
    the case's launches in the main-path run (asserted 1)."""
    from csnappy_tpu_torch.tools.timing import (HBM_BYTES_PER_S, OPS_PER_S, device_profile,
                                                time_ms)

    libs = {case: _library(torch, kl, by_case[case][1], on_card[case], by_case[case][3])
            for case in SITE_LIBRARY}
    for case, (_, lib) in libs.items():
        got = kl.call(by_case[case][1], on_card[case], by_case[case][3])[0]
        assert torch.equal(lib().reshape(got.shape), got), case
    call_ms = {case: [] for case in CALL_SITES}
    lib_ms = {case: [] for case in libs}
    for _ in range(KL_ROUNDS):
        for case in CALL_SITES:
            _, helper, _, params, _ = by_case[case]
            call_ms[case].append(time_ms(lambda: kl.call(helper, on_card[case], params)))
            if case in libs:
                lib_ms[case].append(time_ms(libs[case][1]))
    out = []
    for case, site in CALL_SITES.items():
        _, helper, arrays, params, _ = by_case[case]
        assert case_launches[case] == 1, (case, case_launches[case])
        prof = device_profile(lambda: kl.call(helper, on_card[case], params))
        kernels = {k: c for k, c in prof["calls"].items()
                   if not k.startswith(("Memcpy", "Memset"))}
        rows = arrays["x"].shape[0]
        want = 1 if kl.HELPERS[helper].kind == "shift" else kl.scan_kernels[helper]
        assert not kernels or sum(kernels.values()) == want, (case, prof["calls"], want)
        counts, wrapped = _agree(case, prof["calls"], _wrapper_launches(
            torch, lambda: kl.call(helper, on_card[case], params)))
        nbytes, nops = kl.traffic(helper, arrays, params)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S) * 1e3
        ms = statistics.median(call_ms[case])
        lms = statistics.median(lib_ms[case]) if case in libs else None
        rec = {"case": case, "helper": helper, "site": site, "shape": [rows, 128],
               "ms": ms, "ms_rounds": call_ms[case], "device_ms": prof["device_ms"] or None,
               "kernels_per_call": sum(kernels.values()) if kernels else None,
               "kernels": prof["kernels"], "bound_ms": bound, "bound_bytes": nbytes,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / OPS_PER_S
               else "operations",
               "library": libs[case][0] if case in libs else None, "library_ms": lms,
               "library_ms_rounds": lib_ms.get(case), "launches": case_launches[case],
               "wrapper_kernels_per_call": wrapped}
        out.append(rec)
        print(f"[kernel_lib] {helper} on {case} ({rows}, 128) at {site}: {ms:.4f} ms a call "
              f"(median of {KL_ROUNDS} rounds, {min(call_ms[case]):.4f}-{max(call_ms[case]):.4f}), "
              f"kernels alone {_or_not_measured(prof['device_ms'] or None)}, "
              f"{rec['kernels_per_call'] or 'not measured'} kernel(s) a call, bound "
              f"{bound:.7f} ms ({nbytes} B / 3.35 TB/s), library "
              + (f"{libs[case][0]} {lms:.4f} ms ({min(lib_ms[case]):.4f}-"
                 f"{max(lib_ms[case]):.4f})" if lms is not None else "none")
              + f"; {case_launches[case]} launch in the main-path run; {counts}; card {card}",
              flush=True)
    return out


WIDE_ROWS = 65536               # a tile past every one-block limit: 2^23 elements, 32 MiB


def _wide_tile(torch, np, kl, dev, card: str) -> list:
    """Every shift and scan helper at each configuration of
    ``kernel_lib.SHIFT_SCAN_RUNS`` on a (``WIDE_ROWS``, 128) tile random over
    all of int32 on the card, equal to the plain version (0 differing
    elements), with a call's time, its kernels alone (``device_ms``) and
    its kernels a call from a bracketed trace (asserted equal to one for a
    shift, to what the entry reports for a scan, where the trace holds
    device records: after ``device_profile``'s retakes a trace without them
    leaves the count not measured; at all rounds the row rounds run as grid
    passes), beside the bound (``kernel_lib.traffic`` bytes over 3.35
    TB/s)."""
    from csnappy_tpu_torch.tools.timing import HBM_BYTES_PER_S, device_profile, time_ms

    x = np.random.default_rng(WIDE_ROWS).integers(-(2**31), 2**31, (WIDE_ROWS, 128),
                                                   dtype=np.int64).astype(np.int32)
    xd = torch.from_numpy(x).to(dev)
    out = []
    for helper, args, kw in kl.SHIFT_SCAN_RUNS:
        fn = kl.HELPERS[helper].wrapper
        got = fn(xd, *args, **kw)
        torch.cuda.synchronize()
        want = fn(x, *args, **kw, device="cpu")
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (helper, args, kw, WIDE_ROWS)
        ms = time_ms(lambda: fn(xd, *args, **kw))
        prof = device_profile(lambda: fn(xd, *args, **kw), 3)
        want_kernels = 1 if kl.HELPERS[helper].kind == "shift" else kl.scan_kernels[helper]
        seen = sum(c for k, c in prof["calls"].items() if not k.startswith(("Memcpy", "Memset")))
        assert not seen or seen == want_kernels, (helper, prof["calls"], want_kernels)
        wrapped = _agree(helper, prof["calls"], _wrapper_launches(
            torch, lambda: fn(xd, *args, **kw)))[1]
        shift = {("d" if helper.startswith("stream") else "k"): args[0]} if args and \
            kl.HELPERS[helper].kind == "shift" else {}
        nbytes = kl.traffic(helper, {"x": x}, shift)[0]
        out.append({"helper": helper, "args": list(args), "kw": kw, "ms": ms,
                    "device_ms": prof["device_ms"] or None, "kernels_per_call": seen or None,
                    "wrapper_kernels_per_call": wrapped,
                    "entry_kernels": want_kernels, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    print(f"[kernel_lib] ({WIDE_ROWS}, 128), random int32: every shift and scan equal to its "
          f"plain version; ms a call / kernels alone / bound (kernels a call in the trace, by "
          f"the wrappers' counts): "
          + ", ".join(f"{r['helper']}{tuple(r['args'])}{r['kw'] or ''} {r['ms']:.4f} / "
                      f"{_or_not_measured(r['device_ms'])} / {r['bound_ms']:.4f} "
                      f"({r['kernels_per_call'] or 'not measured'}, "
                      f"{r['wrapper_kernels_per_call']})" for r in out)
          + f"; card {card}", flush=True)
    return out


def _index_add(torch, kl, a, params):
    """One ``index_add_`` computing ``scatter_rows_multi`` inside its
    contract: the stacked tables' in-range positions and masked values,
    prepared outside the timed call."""
    pos, *vals = a.values()
    sl = slice(params["r0"], params["r0"] + params["nrows"])
    p = pos[sl].reshape(-1)
    n_out = 128 * params["out_rows"]
    keep = (p >= 0) & (p < n_out)
    masks = [kl.bits_mask(b, 7) for b in params["bits"]]
    V = torch.stack([v[sl].reshape(-1)[keep] & m if m != kl.FULL else v[sl].reshape(-1)[keep]
                     for v, m in zip(vals, masks)])
    idx = p[keep].long()
    H = torch.zeros((len(vals), n_out), dtype=torch.int32, device=pos.device)
    return ("H.index_add_(1, pos, V) (stacked tables, in-range positions, masked values)",
            lambda: H.index_add_(1, idx, V))


def _tile_index_add(torch, pos, val, n_out: int, mask=None):
    """One ``index_add_`` of one value tile over the whole position tile:
    the in-range positions where ``mask`` is set, prepared outside the
    timed call."""
    keep = (pos >= 0) & (pos < n_out)
    if mask is not None:
        keep &= mask
    p_ok, v_ok = pos[keep].long(), val[keep]
    h = torch.zeros(n_out, dtype=torch.int32, device=pos.device)
    return ("H.index_add_(0, pos, val) (one table, the whole tile, in-range positions)",
            lambda: h.index_add_(0, p_ok, v_ok))


def _index_select(torch, a, params):
    """One ``index_select`` computing ``gather_rows_multi`` inside its
    contract: the stacked tables at rows r0..r0+nrows-1 of the index, clipped
    to the table, prepared outside the timed call."""
    *tbls, ix = a.values()
    stacked = torch.stack([t.reshape(-1) for t in tbls])
    rows = ix[params["r0"] : params["r0"] + params["nrows"]].reshape(-1)
    ix64 = rows.long().clamp(0, stacked.shape[1] - 1)
    return ("torch.index_select(stacked tables, 1, idx)",
            lambda: torch.index_select(stacked, 1, ix64))


def _ptxas(kernel: str, lib: str = "kernel_lib") -> tuple[str, str]:
    """The stack-frame and register lines ``ptxas -v`` printed for ``kernel``
    in the last build of ``csrc/<lib>.cu``."""
    from csnappy_tpu_torch.ops import _build

    log = _build.log_path(lib).read_text().splitlines()
    at = next(i for i, line in enumerate(log) if kernel in line and "Compiling" not in line)
    frame = next(line.strip() for line in log[at:] if "stack frame" in line)
    used = next(line.split(":", 1)[1].strip() for line in log[at:] if "Used" in line)
    return frame, used


def _main_shapes(torch, kl, helper: str, cases, on_card, case_launches: dict, card: str) -> list:
    """``scatter_rows_multi`` or ``gather_rows_multi`` on each case at the
    JAX fused kernels' shapes, and one PyTorch call of the same function
    (``_index_add``, ``_index_select``), timed in ``KL_ROUNDS`` interleaved
    rounds; the kernel alone, the bound (``kernel_lib.traffic``), each case's
    launches in the main-path run (``case_launches``, one a case) and the
    harness's ``ptxas -v`` lines (the gather's stack frame must be 0 bytes)."""
    from csnappy_tpu_torch.tools.timing import (HBM_BYTES_PER_S, OPS_PER_S, device_profile,
                                                time_ms)

    scatter = helper == "scatter_rows_multi"
    harness = "scatter_harness" if scatter else "gather_harness"
    frame, used = _ptxas(harness)
    if not scatter:
        assert frame.startswith("0 bytes stack frame"), frame
    print(f"[kernel_lib] {harness} (ptxas -v): {frame}; {used}; "
          + (f"dynamic shared memory a block {kl.SCATTER_SLICE} positions x limbs x 4 B "
             f"(scatter_plan), 1024 threads" if scatter else
             "no shared memory, a block row a table, one thread an index, the tables read in "
             "place"), flush=True)
    libs = {case: _index_add(torch, kl, on_card[case], c[3]) if scatter
            else _index_select(torch, on_card[case], c[3]) for case, c in cases.items()}
    call_ms = {case: [] for case in cases}
    lib_ms = {case: [] for case in cases}
    for _ in range(KL_ROUNDS):
        for case, (_, _, _, params, _) in cases.items():
            call_ms[case].append(time_ms(lambda: kl.call(helper, on_card[case], params)))
            lib_ms[case].append(time_ms(libs[case][1]))
    out = []
    for case, (_, _, arrays, params, _) in cases.items():
        assert case_launches[case] == 1, (case, case_launches[case])
        device_ms = device_profile(lambda: kl.call(helper, on_card[case], params))["device_ms"]
        nbytes, nops = kl.traffic(helper, arrays, params)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S) * 1e3
        ms, lms = statistics.median(call_ms[case]), statistics.median(lib_ms[case])
        tables = len(params["bits"])
        rec = {"case": case, "tables": tables, "nrows": params["nrows"], "ms": ms,
               "ms_rounds": call_ms[case], "device_ms": device_ms or None, "bound_ms": bound,
               "bound_bytes": nbytes, "bound_ops": nops, "library": libs[case][0],
               "library_ms": lms, "library_ms_rounds": lib_ms[case],
               "launches": case_launches[case], "ptxas": f"{frame}; {used}"}
        if scatter:
            plan = kl.scatter_plan(tables, 128 * params["out_rows"], 0)
            rec.update(out_rows=params["out_rows"], grid=plan.grid, smem=plan.smem)
            what = (f"{tables} tables x {params['out_rows']} rows, rows {params['r0']}.."
                    f"{params['r0'] + params['nrows'] - 1} of a {arrays['pos'].shape[0]}-row tile")
            layout = f"{plan.grid[0]} x {plan.grid[1]} blocks, {plan.smem} B of shared memory each"
        else:
            rows_in = arrays["t0"].shape[0]
            rec.update(table_rows=rows_in)
            what = (f"{tables} tables of ({rows_in}, 128), rows {params['r0']}.."
                    f"{params['r0'] + params['nrows'] - 1} of a {arrays['idx'].shape[0]}-row "
                    f"index tile")
            layout = f"{tables} block row(s) of {128 * params['nrows']} threads"
        out.append(rec)
        print(f"[kernel_lib] {helper} on {case} ({what}): {ms:.4f} ms a call (median of "
              f"{KL_ROUNDS} rounds, {min(call_ms[case]):.4f}-{max(call_ms[case]):.4f}), kernel "
              f"alone {_or_not_measured(device_ms or None)}, bound {bound:.7f} ms ({nbytes} B), "
              f"{libs[case][0]} {lms:.4f} ms ({min(lib_ms[case]):.4f}-{max(lib_ms[case]):.4f}), "
              f"{ms / lms:.2f}x; {case_launches[case]} launch(es) in the main-path run, "
              f"{layout}; card {card}", flush=True)
    return out


def _host_split(torch, kl, helper: str, a: dict, params: dict, n: int = 1000) -> dict:
    """Microseconds of each host step of one call of ``helper`` (a scatter,
    ``gather_rows_multi`` or ``lane_gather``) on the card on the arrays
    ``a``, as the wrapper takes it: each step alone ``n`` times on
    ``time.perf_counter_ns`` after a synchronise, then the whole call.
    ``scatter_sum_tile`` gets the JAX signature's bool mask."""
    from csnappy_tpu_torch.ops.primitives import _stream, as_int32

    def us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter_ns() - t0) / n / 1e3

    dev = next(iter(a.values())).device
    steps = {}
    if helper == "scatter_rows_multi":
        pos, *vals = a.values()
        bits, r0, nrows, out_rows = params["bits"], params["r0"], params["nrows"], params["out_rows"]
        ops, limbs, off = (pos, *vals), 0, 4 * 128 * r0
        masks = kl._masks(tuple(bits), 7)
        mask_ptr, mask_bytes, npos = None, 0, nrows * 128
        steps["operand checks"] = lambda: (kl._operands(None, *ops), kl._masks(tuple(bits), 7))
        steps["conversions"] = lambda: [kl._tile(x, dev, "x") for x in ops]
        steps["row offset"] = lambda: [x.data_ptr() + off for x in ops]
        call = lambda: kl.scatter_rows_multi(pos, list(zip(vals, bits)), r0, out_rows, nrows)
    elif helper == "scatter_sum_tile":
        pos, val = a["pos_row"], a["val_row"]
        mask = a["mask_row"] != 0
        vals, out_rows, off = [val], params["out_rows"], 0
        limbs, masks = kl.bits_mask(params["bits"]).bit_length() // 8, (kl.FULL,)
        mask_ptr, mask_bytes, npos = mask.data_ptr(), mask.element_size(), pos.numel()
        steps["operand checks"] = lambda: kl._operands(None, pos, val, mask)
        steps["conversions"] = lambda: (as_int32(pos, dev, "x"), as_int32(val, dev, "x"),
                                        kl._mask(mask, dev))
        call = lambda: kl.scatter_sum_tile(pos, val, mask, out_rows, params["bits"])
    elif helper == "gather_rows_multi":
        *tables, idx = a.values()
        bits, r0, nrows = params["bits"], params["r0"], params["nrows"]
        ops, off, masks = (idx, *tables), 4 * 128 * r0, kl._masks(tuple(bits))
        steps["operand checks"] = lambda: (kl._operands(None, *ops), kl._masks(tuple(bits)))
        steps["conversions"] = lambda: ([kl._tile(x, dev, "x") for x in ops[:2]]
                                        + [as_int32(x, dev, "x") for x in ops[2:]])
        steps["row offset"] = lambda: idx.data_ptr() + off
        shape = (nrows, 128) if len(tables) == 1 else (len(tables), nrows, 128)
        call = lambda: kl.gather_rows_multi(list(zip(tables, bits)), idx, r0, nrows)
    else:                                       # lane_gather
        x, idx = a.values()
        tables, masks, off, shape = [x], (kl.FULL,), 0, tuple(idx.shape)
        steps["operand checks"] = lambda: kl._operands(None, x, idx)
        steps["conversions"] = lambda: (kl._tile(x, dev, "vals"), as_int32(idx, dev, "li"))
        call = lambda: kl.lane_gather(x, idx)
    if helper.startswith("scatter"):
        ntab, n_out = len(vals), out_rows * 128
        shape = (n_out // 128, 128) if ntab == 1 else (ntab, n_out // 128, 128)
        ptrs = lambda: kl._PTRS(*(v.data_ptr() + off for v in vals))
        ctypes_args = lambda: (ptrs(), kl._uints(masks), kl.scatter_plan(ntab, n_out, limbs).slice)
        what = f"{ntab} table(s) x {out_rows} rows"
    else:
        ntab, entries = len(tables), tables[0].numel()
        ptrs = lambda: kl._PTRS(*[t.data_ptr() for t in tables])
        ctypes_args = lambda: (ptrs(), kl._uints(masks))
        what = f"{ntab} table(s) of {tuple(tables[0].shape)}, {shape[-2] * shape[-1]} indices"
    out = torch.empty(shape, dtype=torch.int32, device=dev)

    def allocate():
        o = out.new_empty(shape)
        return [o] if len(shape) == 2 else list(o.unbind(0))

    steps["allocation"] = allocate
    steps["ctypes arguments"] = ctypes_args
    steps["device and stream"] = lambda: (dev.index == torch.cuda.current_device(),
                                          _stream(dev.index))
    if helper.startswith("scatter"):
        launch, check = kl._entry("scatter")
        args = (pos.data_ptr() + off, mask_ptr, mask_bytes, npos, ptrs(), kl._uints(masks), ntab,
                limbs, n_out, kl.scatter_plan(ntab, n_out, limbs).slice, out.data_ptr(),
                _stream(dev.index))
    else:
        launch, check = kl._entry("gather")
        nidx = out.numel() // ntab
        mode = kl.GATHER_MODES["flat_clip" if helper == "gather_rows_multi" else "row_take"]
        args = (ptrs(), kl._uints(masks), ntab, entries, idx.data_ptr() + off, nidx, shape[-1],
                mode, out.data_ptr(), _stream(dev.index))
    steps["launch entry"] = lambda: check(launch(*args))

    split = {step: us(fn) for step, fn in steps.items()}
    whole = us(call)
    total = sum(split.values())
    print(f"[kernel_lib] host split of one {helper} call ({what}), "
          f"us (time.perf_counter_ns, {n} runs a step): "
          + "; ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f"; the steps {total:.2f}, the whole call {whole:.2f} (the rest: Python between "
          f"the steps)", flush=True)
    return {"steps_us": split, "steps_total_us": total, "call_us": whole}


def _scaleout(torch, np, urls: bytes, fixture: bytes, card: str) -> dict:
    """Phase 14: the sharded codec on a 1-rank NCCL group, then the 2-rank
    gloo loopback on the one card.  Returns rows 1-3's ``launches_sharded``."""
    import tempfile

    import torch.distributed as dist

    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.errors import E_OUTPUT_OVERRUN, SnappyError
    from csnappy_tpu_torch.models import pymodel
    from csnappy_tpu_torch.ops import decode_fused, encode_fused
    from csnappy_tpu_torch.parallel import mesh, multihost

    assert dist.is_nccl_available(), "this torch has no NCCL"
    print(f"[scaleout] torch.distributed with NCCL {torch.cuda.nccl.version()}", flush=True)
    blocks = [urls[i : i + BS] for i in range(0, len(urls), BS)]
    frags = [pymodel.compress_fragment(b) for b in blocks]
    olens = [len(b) for b in blocks]
    body = b"".join(frags)
    data, ps = urls[:65536], PAGE                 # the local-data API: 16 pages of 4 KiB
    pages = np.frombuffer(data, np.uint8).reshape(-1, ps).copy()
    plens = np.full((len(pages),), ps, np.int32)

    multihost.init(f"localhost:{multihost.free_port()}", 1, 0, timeout=60)
    try:
        group = mesh.default_mesh()
        assert dist.get_backend(group) == "nccl" and dist.get_world_size(group) == 1
        wrappers = {"decode_blocks": decode_fused.decode_blocks,
                    "decode_segments": decode_fused.decode_segments,
                    "encode_blocks": encode_fused.encode_blocks}
        for w in wrappers.values():
            w.launches = 0
        decode_fused.launches_by_kernel.update(dict.fromkeys(decode_fused.KERNELS, 0))
        assert mesh.compress_sharded(urls) == fixture, "compress_sharded differs from the fixture"
        assert b"".join(mesh.decompress_fragments_sharded(frags, olens)) == urls
        code = None
        try:
            mesh.decompress_fragments_sharded(frags[:2], [olens[0], olens[1] - 1])
        except SnappyError as e:
            code = e.code
        assert code == E_OUTPUT_OVERRUN, code
        comp, clens, offs = multihost.compress_blocks_multihost(pages, plens)
        cl = clens.cpu().to(torch.int64)
        assert torch.equal(offs, torch.cumsum(cl, 0) - cl), offs
        launches = {k: w.launches for k, w in wrappers.items()}
        by_kernel = dict(decode_fused.launches_by_kernel)
        # one encode a compress, one decode_segments a decompress (two calls each)
        assert launches == {"decode_blocks": 0, "decode_segments": 2, "encode_blocks": 2}, launches
        assert by_kernel == {"decode_kernel": 2, **dict.fromkeys(decode_fused.WIDE_KERNELS, 0)}, \
            by_kernel
        print(f"[scaleout] 1-rank NCCL group on the card: compress_sharded(urls.10K) "
              f"byte-identical to the JAX fixture ({len(fixture)} B); decompress_fragments_sharded "
              f"of the oracle's {len(frags)} fragments joined to urls.10K; a fragment one byte over "
              f"its own limit raised E_OUTPUT_OVERRUN; compress_blocks_multihost offsets equal "
              f"to the exclusive cumsum; launches {launches}, decoder kernels {by_kernel}",
              flush=True)

        ops_c = _device_ops(torch, lambda: mesh.compress_sharded(urls), "compress_sharded")
        ops_d = _device_ops(torch, lambda: mesh.decompress_fragments_sharded(frags, olens),
                            "decompress_fragments_sharded")
        for what, ops, name in (("compress_sharded", ops_c, "encode_kernel"),
                                ("decompress_fragments_sharded", ops_d, "decode_kernel")):
            codec = {k: v for k, v in ops.items() if name in k}
            assert list(codec.values()) == [1], (what, ops)
            nccl = {k: v for k, v in ops.items() if "nccl" in k.lower()}
            print(f"[scaleout] one {what} call runs {name} once; its device operations "
                  f"(torch.profiler, a call): {ops}; NCCL's: {nccl or 'none named nccl'}",
                  flush=True)

        comm = mesh.comm_device(group)
        pad = np.zeros((len(blocks) * BS,), np.uint8)
        pad[: len(urls)] = np.frombuffer(urls, np.uint8)
        ec, el = encode_fused.encode_blocks(pad.reshape(-1, BS), np.array(olens, np.int32))
        width = int(el.max())
        rows_dev = ec[:, :width].contiguous()
        calls = {"compress_sharded": lambda: mesh.compress_sharded(urls),
                 "api.compress": lambda: api.compress(urls),
                 "decompress_fragments_sharded":
                     lambda: mesh.decompress_fragments_sharded(frags, olens),
                 "api.decompress_noheader": lambda: api.decompress_noheader(body, len(urls))}
        times = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):        # in turns
            for k in order:
                times[k].append(_lone_ms(torch, calls[k]))
        gather_lens = _lone_ms(torch, lambda: mesh.all_gather(el, group, comm))
        gather_rows = _lone_ms(torch, lambda: mesh.all_gather(rows_dev, group, comm))
        gap_c = [a - b for a, b in zip(times["compress_sharded"], times["api.compress"])]
        gap_d = [a - b for a, b in zip(times["decompress_fragments_sharded"],
                                       times["api.decompress_noheader"])]
        print(f"[scaleout] host ms, median of 20 lone calls (two readings, in turns) on urls.10K: "
              f"{ {k: [round(x, 4) for x in v] for k, v in times.items()} }; the sharded calls' "
              f"gap, compress {[round(x, 4) for x in gap_c]}, decompress "
              f"{[round(x, 4) for x in gap_d]}; NCCL all_gather alone at one rank: lengths "
              f"int32[{len(el)}] {gather_lens:.4f} ms, rows uint8[{len(el)}, {width}] "
              f"{gather_rows:.4f} ms; card {card}", flush=True)
    finally:
        dist.destroy_process_group()

    # two ranks on the one card: gloo, each rank's lengths copied to the host
    per = len(pages) // 2
    copy_lens = _lone_ms(torch, lambda: clens[:per].to("cpu"))
    copy_rows = _lone_ms(torch, lambda: rows_dev[: -(-len(blocks) // 2)].to("cpu"))
    with tempfile.TemporaryDirectory(prefix="scaleout_") as tmp:
        port = multihost.free_port()
        t0 = time.perf_counter()
        multihost.launch([["-m", "csnappy_tpu_torch.parallel.multihost", "--worker",
                           "--rank", str(r), "--nprocs", "2", "--port", str(port),
                           "--out", f"{tmp}/part{r}.npz", "--nbytes", str(len(data)),
                           "--device", "cuda", "--backend", "gloo"]
                          for r in range(2)], 180)
        wall = time.perf_counter() - t0
        parts = []
        for r in range(2):
            with np.load(f"{tmp}/part{r}.npz") as z:
                parts.append({k: z[k] for k in z.files})
    assert np.array_equal(parts[0]["offsets"], parts[1]["offsets"])
    lc = np.concatenate([p["comp"] for p in parts])
    ll = np.concatenate([p["clens"] for p in parts])
    assert np.array_equal(ll, clens.cpu().numpy()) and np.array_equal(lc, comp.cpu().numpy()), \
        "the loopback's rows differ from one card's encode_blocks"
    assert np.array_equal(parts[0]["offsets"], offs.numpy())
    print(f"[scaleout] 2-process --worker loopback on the one card (gloo): {len(ll)} pages of "
          f"{ps} B byte-identical to one encode_blocks on the card, the same offsets on both "
          f"ranks; wall {wall:.2f} s (two processes' start-up included)", flush=True)
    print(f"[scaleout] the host copy gloo needs on the card: a rank's lengths int32[{per}] "
          f"{copy_lens:.4f} ms, a 2-rank compress_sharded shard's rows uint8["
          f"{-(-len(blocks) // 2)}, {width}] {copy_rows:.4f} ms (host clock, synchronised)",
          flush=True)
    return {"decode_blocks": by_kernel["decode_kernel"],
            "decode_segments": launches["decode_segments"],
            "encode_blocks": launches["encode_blocks"]}


def _hygiene(card: str) -> dict:
    """Phase 15: the hygiene harness in a fresh process (its allocator must
    come before any CUDA allocation there); prints its JSON lines and asserts
    every kernel of ``hygiene.KERNELS`` ran in both poisons with no call
    differing, no guard byte changed and no hang.  Returns its summary."""
    from csnappy_tpu_torch.tools import hygiene

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "csnappy_tpu_torch.tools.hygiene", "--seed",
                        str(HYGIENE_SEED), "--seconds", str(HYGIENE_SECONDS)], cwd=ROOT,
                       capture_output=True, text=True, timeout=HYGIENE_SECONDS + 600)
    lines = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    for line in lines:
        print(json.dumps(line), flush=True)
    assert p.returncode == 0, (p.returncode, (p.stdout + p.stderr)[-3000:])
    per = {line["hygiene"]: line for line in lines if "hygiene" in line}
    assert set(per) == set(hygiene.KERNELS), sorted(set(hygiene.KERNELS) - set(per))
    for k, line in per.items():
        assert line["poisons"] == ["0x5a", "0xa5"], (k, line["poisons"])
        assert line["differed"] == line["guard_violations"] == 0, (k, line)
    summ = next(line for line in lines if "hygiene_summary" in line)
    s = summ["hygiene_summary"]
    print(f"[hygiene] {s['kernels']} kernels, {s['cases']} cases, {s['calls']} calls "
          f"({s['occupied']} behind the occupier; decoders {s['decoder_calls']}, "
          f"{s['decoder_occupied']} occupied) in poisons 0xA5 and 0x5A: {s['differed']} differed, "
          f"{s['guard_violations']} guard bytes changed, no hang; "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    return s


def _bench_records(urls: bytes, row1_ms) -> float:
    """Phase 16: the bench line (``bench_torch.main``, 5 timed calls a
    figure), its block decode beside row 1's launch (``row1_ms()``, as
    phase 5 times it) in turns, and the records step (``tools/records.main``
    into a temporary directory) in this process, each output checked.
    Returns the bench line's block decode GB/s."""
    import contextlib
    import io
    import math
    import tempfile

    import torch

    import bench_torch
    from csnappy_tpu_torch.ops import decode_fused, encode_fused
    from csnappy_tpu_torch.tools import records
    from csnappy_tpu_torch.tools.timing import card as card_of

    card = card_of()

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--reps", "5"])
    bench_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    assert rc == 0 and len(lines) == 1, (rc, lines)
    line = json.loads(lines[0])
    assert tuple(line) == bench_torch.KEYS and len(line) == 15, sorted(line)
    assert line["compressed_bytes"] == 354567 and line["device"] == card, line
    rates = [line[k] for k in ("value", "wholestream_decompress_GBps",
                               "wholestream_host_e2e_GBps", "compress_GBps")]
    assert min(rates + list(line["decode_GBps_by_batch"].values())) > 0, line
    assert 0 < line["roofline_utilization_pct"] <= 100, line
    print(f"[bench] {json.dumps(line)}", flush=True)
    print(f"[bench] block decode {line['value']} GB/s; {bench_s:.1f} s", flush=True)
    turns = {"row 1": [], "bench": []}
    for _ in range(3):                          # row 1, bench, bench, row 1
        for k in ("row 1", "bench", "bench", "row 1"):
            ms = row1_ms() if k == "row 1" else 1e3 * bench_torch.bench_block_decode(
                urls, B, 20, torch.device("cuda"))[1]
            turns[k].append(round(B * BS / ms / 1e6, 4))
    print(f"[bench] B=64 block decode in turns, GB/s (median of 20 launches each): row 1's "
          f"launch {turns['row 1']}, bench_torch's {turns['bench']}", flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="records_") as out:
        assert records.main(["--out", out]) == 0
        texts = {name: (pathlib.Path(out) / name).read_text() for name in records.RUNS}
    records_s = time.perf_counter() - t0
    assert sorted(texts) == sorted(records.RUNS) and all(t.strip() for t in texts.values()), \
        {k: len(v) for k, v in texts.items()}
    for which, names in (("decode", decode_fused.PHASES), ("encode", encode_fused.PHASES)):
        prof = [json.loads(x) for x in texts[f"torch_phaseprof_{which}.jsonl"].splitlines()]
        phases = [r for r in prof if "phase" in r]
        assert tuple(r["phase"] for r in phases) == names, prof
        assert math.isclose(sum(r["delta_ms"] for r in phases), phases[-1]["cum_ms"],
                            rel_tol=1e-12), prof
        assert prof[-1]["device"] == card and len(prof) == len(names) + 1, prof
        for r in prof:
            print(f"[phaseprof] {which} {json.dumps(r)}", flush=True)
    table = texts["torch_benchtable.txt"].splitlines()
    assert table[0] == f"backend=torch device={card}", table[0]
    assert any(x.startswith("urls.10K") and "702087 ->   354567" in x for x in table), table
    assert json.loads(texts["torch_zramsim.json"])["device"] == card
    full = json.loads(texts["torch_bench.json"])
    assert sorted(full["decode_GBps_by_batch"]) == ["16", "256", "64"], full
    assert full["compressed_bytes"] == 354567 and full["device"] == card, full
    print(f"[records] {sorted(texts)} written and checked in {records_s:.1f} s: "
          f"{ {k: len(v) for k, v in texts.items()} } B; bench --full decode by batch "
          f"{full['decode_GBps_by_batch']}", flush=True)
    return line["value"]


def _group_decode(torch, np, dev, card: str) -> dict:
    """Phases 2-5: the codec kernels on the B=64 batch, the fixtures and
    the wide rows, the main path with its launch counts, the times.
    Returns rows 1-3, rows 1-2's wide path after rows 1-2."""
    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import pymodel, wire
    from csnappy_tpu_torch.ops import decode_fused, encode_fused
    from csnappy_tpu_torch.runtime import native
    from csnappy_tpu_torch.tools import phaseprof
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    name_, power_, clock_ = (s.strip() for s in card.split(","))
    urls, golden, fixture, unaligned = _data()
    baddata3 = (DATA / "baddata3.snappy").read_bytes()

    # ----------------------------------------------------------- 2. decode
    frag_of, blocks, frags, comp, lens = _main_batch(torch, urls)
    got = decode_fused.decode_blocks(comp.to(dev), lens, BS, device=dev)
    torch.cuda.synchronize()
    err_dec = _same("decode_blocks B=64", got, decode_fused.decode_blocks(
        comp, lens, BS, device="cpu"))
    for i, b in enumerate(blocks):
        assert int(got[1][i]) == len(b) and got[0][i, : len(b)].cpu().numpy().tobytes() == b
    tags = [_tags(f)[0] for f in frags]
    print(f"[decode] B=64 x 32 KiB equal to plain and to the source; tags/block max "
          f"{max(tags)} mean {sum(tags) / B:.0f}; compressed {int(lens.sum())} B", flush=True)

    rng = np.random.default_rng(7)
    prio = bytearray()                       # bad offset before the overrun point
    wire.emit_literal(prio, b"ab")
    prio += bytes([wire.TAG_COPY_1, 50])
    wire.emit_literal(prio, b"c" * 60)
    bad = [baddata3[wire.varint_decode(baddata3)[1]:], b"\xc4foooooo", bytes(prio),
           pymodel.compress_fragment(b"y" * 5000)[:-1]]   # overrun before the truncated end
    for _ in range(12):
        m = bytearray(frag_of[int(rng.integers(0, 21))])
        for _k in range(int(rng.integers(1, 6))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        bad.append(bytes(m))
    mcomp, mlens = _pack(torch, bad)
    statuses = {}
    for cap in (0, 4, 4096, BS):
        g = decode_fused.decode_blocks(mcomp.to(dev), mlens, cap, device=dev)
        torch.cuda.synchronize()
        _same(f"decode_blocks malformed cap={cap}", g,
              decode_fused.decode_blocks(mcomp, mlens, cap, device="cpu"))
        statuses[cap] = g[2].cpu().tolist()
    assert statuses[4][2] == -5 and statuses[4096][3] == -3 and statuses[BS][1] == -5, statuses
    print(f"[decode] {len(bad)} malformed/priority vectors equal to plain at caps 0, 4, 4096, "
          f"32768; statuses at 32768: {statuses[BS]}", flush=True)

    body = golden[wire.varint_decode(golden)[1]:]
    rc, offs, produced = native.scan_segments(body, len(urls), BS)
    assert rc == 0 and produced == len(urls), (rc, produced)
    slens = np.diff(np.append(offs, len(body)))
    sdl = np.minimum(BS, len(urls) - np.arange(len(offs)) * BS)
    body_dev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    gseg = decode_fused.decode_segments(body_dev, offs, slens, sdl, device=dev)
    torch.cuda.synchronize()
    err_seg = _same("decode_segments", gseg, decode_fused.decode_segments(
        body, offs, slens, sdl, device="cpu"))
    assert gseg[0].reshape(-1)[: len(urls)].cpu().numpy().tobytes() == urls
    seg_tags = [_tags(body[o : o + n])[0] for o, n in zip(offs, slens)]
    print(f"[decode] decode_segments over urls.10K.snappy ({len(offs)} segments) equal to "
          f"plain and to urls.10K; tags/segment max {max(seg_tags)}", flush=True)
    dadv_rounds = _decode_fixtures(torch, np, dev, decode_fused)
    pages = [pymodel.compress_fragment(urls[i * 3000 : i * 3000 + PAGE]) for i in range(200)]
    pcomp, plens = _pack(torch, pages)
    _same("decode_blocks 200 x 4 KiB", decode_fused.decode_blocks(pcomp.to(dev), plens, PAGE),
          decode_fused.decode_blocks(pcomp, plens, PAGE, device="cpu"))
    print(f"[decode] 200 pages of {PAGE} B equal to plain (decode_kernel)", flush=True)
    wide_errs = _wide_checks(torch, np, dev, decode_fused)
    repeats = wide_repeats(WIDE_REPEATS, dev)
    assert repeats["differed"] == {"segments": 0, "blocks": 0}, repeats
    print(f"[decode] the main path's wide decode_segments batch (limits 702,087, 32,768, 2^18 at "
          f"unaligned offsets) {WIDE_REPEATS} times, from host bytes and a card tensor in turn, "
          f"each beside the body as one decode_blocks row: {repeats}", flush=True)

    # ----------------------------------------------------------- 3. encode
    data = torch.zeros((B, BS), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        data[i, : len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    blens = torch.full((B,), BS, dtype=torch.int32)
    ec, en = encode_fused.encode_blocks(data.to(dev), blens, device=dev)
    torch.cuda.synchronize()
    pc, pn = encode_fused.encode_blocks(data, blens, device="cpu")
    assert (en.cpu() == pn).all(), "encode lengths differ"
    err_enc = int((ec.cpu().int() - pc.int()).abs().max())
    assert err_enc == 0, f"encode bytes differ (max abs err {err_enc})"
    commits = [_tags(ec[i, : int(en[i])].cpu().numpy().tobytes())[1] for i in range(B)]
    seg = BS // 32                            # the kernel walks 32 segments side by side
    seg_max = max(int(np.bincount(np.array(_copy_starts(ec[i, : int(en[i])].cpu().numpy()
                                                        .tobytes()), np.int64) // seg,
                                  minlength=32).max())
                  for i in range(B))
    stream = encode_fused.compress_np(urls, device=dev)
    assert stream == fixture, f"compress_np: {len(stream)} B, not the fixture's {len(fixture)} B"
    print(f"[encode] B=64 x 32 KiB equal to plain ({int(en.sum())} B); compress_np(urls.10K) "
          f"= {len(stream)} B, byte-identical to the JAX fixture; commits/block max "
          f"{max(commits)}, commits/segment of {seg} B max {seg_max}", flush=True)
    with np.load(DATA / "torch_ref" / "blocks.npz") as z:
        for group in ("e1k", "e4k", "eadv"):
            gd, gl = z[f"{group}_data"], z[f"{group}_lens"]
            gc, gn = encode_fused.encode_blocks(torch.from_numpy(gd).to(dev), gl, device=dev)
            wc, wn = encode_fused.encode_blocks(gd, gl, device="cpu")
            assert gn.cpu().tolist() == wn.tolist() == z[f"{group}_clen"].tolist(), group
            assert np.array_equal(gc.cpu().numpy(), z[f"{group}_comp"]), group
            assert torch.equal(gc.cpu(), wc), group
    nr = -(-len(urls) // PAGE)                # urls.10K as the container pages it
    pages = np.zeros((nr * PAGE,), np.uint8)
    pages[: len(urls)] = np.frombuffer(urls, np.uint8)
    pages = pages.reshape(nr, PAGE)
    plens = np.full((nr,), PAGE, np.int32)
    plens[-1] = len(urls) - (nr - 1) * PAGE
    gc, gn = encode_fused.encode_blocks(torch.from_numpy(pages).to(dev), plens, device=dev)
    wc, wn = encode_fused.encode_blocks(pages, plens, device="cpu")
    assert torch.equal(gn.cpu(), wn) and torch.equal(gc.cpu(), wc), "4 KiB pages differ"
    print(f"[encode] the JAX fixtures' e1k, e4k and eadv groups equal on the card (and the "
          f"plain version); urls.10K as {nr} pages of {PAGE} B equal to plain "
          f"({int(gn.sum())} B)", flush=True)

    # -------------------------------------------------------- 4. main path
    wrappers = {"decode_blocks": decode_fused.decode_blocks,
                "decode_segments": decode_fused.decode_segments,
                "encode_blocks": encode_fused.encode_blocks}
    for w in wrappers.values():
        w.launches = 0
    decode_fused.launches_by_kernel.update(dict.fromkeys(decode_fused.KERNELS, 0))
    mc, ml = encode_fused.encode_blocks(data.numpy(), blens.numpy())
    assert torch.equal(mc.cpu(), pc) and torch.equal(ml.cpu(), pn)
    mo, mp, ms_ = decode_fused.decode_blocks(comp.numpy(), lens.numpy(), BS)
    assert (ms_.cpu() == 0).all() and torch.equal(mo.cpu(), got[0].cpu())
    assert api.compress(urls) == fixture
    assert api.decompress(golden) == urls
    assert api.decompress(fixture) == urls
    assert api.decompress_noheader(api.compress_fragment(urls[:BS]), BS) == urls[:BS]
    assert api.decompress(api.compress(unaligned)) == unaligned
    # rows past 32 KiB: urls.10K.snappy's body as one row of 702,087 B, then
    # one decode_segments batch of that body, a 32 KiB fragment and a w256k
    # row; each call's launches, of each wrapper and each decoder kernel,
    # counted around it
    def counted(fn):
        calls0 = {k: w.launches for k, w in wrappers.items()}
        kern0 = dict(decode_fused.launches_by_kernel)
        got_ = fn()
        return got_, {"calls": {k: w.launches - calls0[k] for k, w in wrappers.items()},
                      "kernels": {k: v - kern0[k] for k, v in decode_fused.launches_by_kernel.items()}}

    wide_comp, wide_lens = np.frombuffer(body, np.uint8)[None, :].copy(), np.array([len(body)])
    (wo, wp, ws_), wide_blocks = counted(
        lambda: decode_fused.decode_blocks(wide_comp, wide_lens, len(urls)))
    assert (int(wp[0]), int(ws_[0])) == (len(urls), 0) and wo[0].cpu().numpy().tobytes() == urls
    mixed_body, mixed_offs, mixed_lens, mixed_dl, mixed_want = main_path_batch()
    (mo2, mp2, ms2), wide_segs = counted(
        lambda: decode_fused.decode_segments(mixed_body, mixed_offs, mixed_lens, mixed_dl))
    assert ms2.cpu().tolist() == [0, 0, 0], ms2
    assert mp2.cpu().tolist() == [len(w) for w in mixed_want] == mixed_dl.tolist(), mp2
    for i, w in enumerate(mixed_want):
        assert mo2[i, : len(w)].cpu().numpy().tobytes() == w, f"main-path batch row {i} differs"
        assert not mo2[i, len(w):].any(), f"main-path batch row {i} not zero past produced"
    launches = {k: w.launches for k, w in wrappers.items()}
    assert all(n > 0 for n in launches.values()), launches
    by_kernel = dict(decode_fused.launches_by_kernel)
    # each wide call: one call of its own wrapper, the three wide kernels once
    wide_counts = {"decode_blocks": wide_blocks, "decode_segments": wide_segs}
    for w, cnt in wide_counts.items():
        assert cnt["calls"] == {k: int(k == w) for k in wrappers}, (w, cnt)
        assert cnt["kernels"] == {k: int(k != "decode_kernel") for k in by_kernel}, (w, cnt)
    wide_calls = {w: cnt["calls"][w] for w, cnt in wide_counts.items()}
    # the calls of rows 1-2 that went through decode_kernel
    narrow_calls = {w: launches[w] - wide_calls[w] for w in wide_calls}
    assert by_kernel == {"decode_kernel": sum(narrow_calls.values()),
                         **{k: sum(c["kernels"][k] for c in wide_counts.values())
                            for k in decode_fused.WIDE_KERNELS}}, by_kernel
    print(f"[main] B=64 batch, api compress/decompress and two wide calls (a row of "
          f"{len(urls)} B; a decode_segments batch at limits {mixed_dl.tolist()}) end to end on "
          f"the card; launches {launches}, decoder kernels {by_kernel}; counted around each wide "
          f"call {wide_counts}; decode_kernel calls by wrapper {narrow_calls}", flush=True)
    data_dev, blens_np = data.to(dev), blens.numpy()
    enc_kernels = _device_kernels(torch, lambda: encode_fused.encode_blocks(data_dev, blens_np),
                                  "encode_blocks")
    assert len(enc_kernels) == 1 and list(enc_kernels.values()) == [1], enc_kernels
    assert "encode_kernel" in next(iter(enc_kernels)), enc_kernels
    assert not any(w in k.lower() for k in enc_kernels
                   for w in ("sort", "scan", "gather", "scatter", "cum", "reduce")), enc_kernels
    print(f"[main] one encode_blocks call on card tensors runs {sum(enc_kernels.values())} "
          f"device kernel: {enc_kernels} (torch.profiler; copies not counted)", flush=True)
    comp_dev, lens_np = comp.to(dev), lens.numpy()
    for what, fn, name in (
            ("decode_blocks", lambda: decode_fused.decode_blocks(comp_dev, lens_np, BS),
             "decode_kernel"),
            ("decode_segments", lambda: decode_fused.decode_segments(body_dev, offs, slens, sdl),
             "decode_kernel")):
        dk = _device_kernels(torch, fn, what)
        assert len(dk) == 1 and list(dk.values()) == [1] and name in next(iter(dk)), (what, dk)
        print(f"[main] one {what} call on card tensors runs 1 device kernel: {dk} "
              f"(torch.profiler; copies not counted)", flush=True)
    wide_dev = torch.from_numpy(wide_comp).to(dev)
    wops = _device_ops(torch, lambda: decode_fused.decode_blocks(wide_dev, wide_lens, len(urls)),
                       "decode_blocks wide")
    wk = {k: v for k, v in wops.items() if not k.startswith(("Memcpy", "Memset"))}
    assert sorted(wk.values()) == [1, 1, 1] and all(
        any(n in k for k in wk) for n in decode_fused.WIDE_KERNELS), wops
    assert sum(v for k, v in wops.items() if k.startswith("Memset")) == 1, wops
    print(f"[main] one decode_blocks call on a card row of {len(urls)} B runs one memset and "
          f"3 device kernels, the wide chain, segment and finish kernels once each: {wops} "
          f"(torch.profiler; the copy is its offsets, lengths, limits and plan)", flush=True)
    from csnappy_tpu_torch.ops import decode_ws

    dk = _device_kernels(torch, lambda: decode_ws.decompress_noheader_ws(body_dev, len(urls)),
                         "decode_ws")
    assert sorted(dk.values()) == [1, 1] and any("scan_kernel" in k for k in dk) \
        and any("decode_kernel" in k for k in dk), dk
    print(f"[main] one decode_ws.decompress_noheader_ws call on card tensors (urls.10K.snappy) "
          f"runs 2 device kernels, the scan's and decode_kernel: {dk} (torch.profiler; the "
          f"workspace memset and the copies not counted)", flush=True)

    # ------------------------------------------------------------ 5. times
    flat, offs_b, lens_b, dl_b = _launch_args(torch, dev, comp, lens)
    dec_ms = time_ms(lambda: decode_fused._launch(
        decode_fused.decode_blocks, flat, offs_b, lens_b, dl_b, BS))
    dec_plain = _host_ms(lambda: decode_fused.decode_blocks(comp, lens, BS, device="cpu"))
    offs_s = torch.as_tensor(offs, dtype=torch.int64, device=dev)
    lens_s = torch.as_tensor(slens, dtype=torch.int32, device=dev)
    dl_s = torch.as_tensor(sdl, dtype=torch.int32, device=dev)
    seg_ms = time_ms(lambda: decode_fused._launch(
        decode_fused.decode_segments, body_dev, offs_s, lens_s, dl_s, BS))
    seg_plain = _host_ms(lambda: decode_fused.decode_segments(body, offs, slens, sdl,
                                                              device="cpu"))
    blens_dev = blens.to(dev)
    ow, wcap = encode_fused.ocap(BS), encode_fused.walk_cap(BS)
    enc_ms = time_ms(lambda: encode_fused._launch(data_dev, blens_dev, BS, ow, wcap))
    enc_call_ms = time_ms(lambda: encode_fused.encode_blocks(data_dev, blens_np))

    enc_lone_ms = _lone_ms(torch, lambda: encode_fused.encode_blocks(data_dev, blens_np))
    enc_kernel_ms = sum(device_profile(lambda: encode_fused._launch(
        data_dev, blens_dev, BS, ow, wcap))["kernels"].values()) or None
    pages_dev, plens_dev = torch.from_numpy(pages).to(dev), torch.from_numpy(plens).to(dev)
    pages_ms = time_ms(lambda: encode_fused._launch(pages_dev, plens_dev, PAGE,
                                                    encode_fused.ocap(PAGE),
                                                    encode_fused.walk_cap(PAGE)))
    print(f"[times] encode_blocks on urls.10K as {nr} pages of {PAGE} B (the container's "
          f"shape): {pages_ms:.4f} ms", flush=True)
    for what, x, xl, bs_ in (("B=64 x 32 KiB", data_dev, blens_dev, BS),
                             (f"{nr} x 4 KiB", pages_dev, plens_dev, PAGE)):
        summ = phaseprof.encode_summary(phaseprof.stamped_encode(x, xl, bs_)[1])
        if bs_ == BS:                                       # the main path's go in the row
            phases = summ["phases"]
        print(f"[times] encode_kernel phases at {what}, SM cycles (slowest block "
              f"{summ['slowest_block']}: {summ['cycles']} in all; median block beside): "
              f"{summ['phases']}", flush=True)
    print(f"[times] encode_kernel shared memory {encode_fused.smem_bytes(BS)} B at bs = {BS}, "
          f"{encode_fused.smem_bytes(PAGE)} B at bs = {PAGE} (dynamic; ptxas above)", flush=True)
    enc_plain = _host_ms(lambda: encode_fused.encode_blocks(data, blens, device="cpu"))

    # the decoder: the kernel alone, a call, a lone call, its phases
    dec = {}
    for name, wrapper, args, call in (
            ("decode_blocks", decode_fused.decode_blocks, (flat, offs_b, lens_b, dl_b),
             lambda: decode_fused.decode_blocks(comp_dev, lens_np, BS)),
            ("decode_segments", decode_fused.decode_segments, (body_dev, offs_s, lens_s, dl_s),
             lambda: decode_fused.decode_segments(body_dev, offs, slens, sdl))):
        kernel_ms = sum(device_profile(
            lambda: decode_fused._launch(wrapper, *args, BS))["kernels"].values()) or None
        _, st = phaseprof.stamped_decode(wrapper, args, BS)
        dec[name] = dict(kernel_ms=kernel_ms, call_ms=time_ms(call), lone_ms=_lone_ms(torch, call),
                         phases_cycles=phaseprof.decode_summary(st))
        d = dec[name]
        print(f"[times] {name}: decode_kernel alone {_or_not_measured(kernel_ms)}, a call "
              f"{d['call_ms']:.4f} ms (CUDA events), a lone call {d['lone_ms']:.4f} ms (host "
              f"clock); SM cycles {d['phases_cycles']}", flush=True)
    frame, used = _ptxas("decode_kernel", "decode_blocks")
    print(f"[times] decode_kernel ptxas -v: {frame}; {used}; shared memory "
          f"{decode_fused.layout(BS)} at {BS} B rows, {decode_fused.layout(PAGE)} at {PAGE} B "
          f"(dynamic)", flush=True)
    wide = _wide_times(torch, np, dev, decode_fused, urls, body)

    rows = []
    # bytes each function must move: every input tensor read once (per-block
    # offsets, lengths and limits included), every output tensor written once
    nseg = len(offs)
    for name, replaces, ms, plain_ms, nin, nout, steps, err in (
        ("decode_blocks", "csnappy_tpu/ops/decode_fused.py:714", dec_ms, dec_plain,
         int(lens.sum()) + 16 * B, B * BS + 8 * B, max(tags), err_dec),
        ("decode_segments", "csnappy_tpu/ops/decode_fused.py:782", seg_ms, seg_plain,
         len(body) + 16 * nseg, nseg * BS + 8 * nseg, max(seg_tags), err_seg),
        ("encode_blocks", "csnappy_tpu/ops/encode_fused.py:602", enc_ms, enc_plain,
         B * BS + 4 * B, B * ow + 8 * B, 2 * seg_max + 32, err_enc),
    ):
        bound_ms, bound_by = _bound(nin + nout)
        steps_printed = steps if name == "encode_blocks" else -(-steps // 8)   # 8 tags a step
        src = "csnappy_tpu_torch/csrc/" + ("encode" if name == "encode_blocks" else "decode") \
            + "_blocks.cu"
        useful = B * BS if name != "decode_segments" else len(urls)   # uncompressed bytes
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "GBps": useful / (ms * 1e-3) / 1e9,
               "bytes": nin + nout, "chain_steps": steps_printed}
        if name == "encode_blocks":
            row.update(kernel_ms=enc_kernel_ms, call_ms=enc_call_ms, lone_ms=enc_lone_ms,
                       commits_max=max(commits), phases_cycles=phases,
                       smem_bytes=encode_fused.smem_bytes(BS))
        else:
            row.update(dec[name], tags_max=steps,
                       smem_bytes=decode_fused.smem_bytes("decode_kernel", BS),
                       launches=narrow_calls[name], launches_by_kernel=by_kernel)
            if name == "decode_blocks":
                row["dadv_rounds"] = dadv_rounds
        rows.append(row)
        print(f"[times] {name}: {ms:.4f} ms ({row['GBps']:.3f} GB/s of uncompressed bytes), "
              f"plain {plain_ms:.1f} ms (host CPU), bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']} ({nin + nout} B), serial chain {steps_printed} steps"
              + (f" (2 x the longest segment's {seg_max} commits + 32; the longest block's "
                 f"{max(commits)} commits walked by one thread); kernel alone "
                 f"{_or_not_measured(enc_kernel_ms)}, a call {enc_call_ms:.4f} ms (CUDA "
                 f"events), a lone call {enc_lone_ms:.4f} ms (host clock)"
                 if name == "encode_blocks" else
                 f" (the longest block's {steps} tags, walked eight a step)"), flush=True)
    rows[2:2] = [dict(name=f"{w}_wide", route="cuda",
                      source="csnappy_tpu_torch/csrc/decode_wide.cu", replaces=rep,
                      launches=wide_calls[w], max_abs_err=wide_errs[w],
                      kernels=list(decode_fused.WIDE_KERNELS),
                      launches_by_kernel=wide_counts[w]["kernels"], **wide[w])
                 for w, rep in (("decode_blocks", "csnappy_tpu/ops/decode_fused.py:714"),
                                ("decode_segments", "csnappy_tpu/ops/decode_fused.py:782"))]
    print(f"[times] card {name_}, power limit {power_}, max SM clock {clock_}", flush=True)
    return {"rows": rows}


def _group_streams(torch, np, dev, card: str) -> dict:
    """Phase 6: the whole-stream kernels.  Returns rows 4-5."""
    urls, golden, _, unaligned = _data()
    return {"rows": _whole_stream(torch, np, dev, urls, golden, unaligned, card)}


def _group_container(torch, np, dev, card: str) -> dict:
    """Phases 7-9: the container (its launches of rows 1-3, for the rows of
    the groups before it), its fixture, the CLI."""
    urls, golden, fixture, _ = _data()
    launches = _container(torch, np, dev, card)
    _container_fixture(np, dev)
    _cli(urls, golden, fixture)
    return {"annotate": {"launches_container": launches}}


def _group_movebench(torch, np, dev, card: str) -> dict:
    """Phase 10: rows 12-13.  A group of its own: every CUDA process that
    phase 9's CLI starts makes each later profiler session of the process
    that started it lose one more of its first records
    (``tools/profiler_loss.py --sessions``)."""
    return {"rows": _movebench(torch, np, dev, card)}


def _group_primitives(torch, np, dev, card: str) -> dict:
    """Phase 11: rows 6-11."""
    return {"rows": _primitives(torch, np, dev, card)}


def _group_probes(torch, np, dev, card: str) -> dict:
    """Phase 12: rows 14a-14i, and the ``walk_smem`` step the parent counts
    the serial chains in."""
    rows, recs = _probes(torch, np, dev, card)
    return {"rows": rows,
            "values": {"walk_smem_cycles": recs["mosaic_probe.walk_smem"]["cycles_per_iter"]}}


def _group_kernel_lib(torch, np, dev, card: str) -> dict:
    """Phase 13: rows 15a-15b."""
    return {"rows": _kernel_lib(torch, np, dev, card)}


def _group_scaleout(torch, np, dev, card: str) -> dict:
    """Phase 14: rows 1-3's launches in the sharded run."""
    urls, _, fixture, _ = _data()
    return {"annotate": {"launches_sharded": _scaleout(torch, np, urls, fixture, card)}}


def _group_hygiene(torch, np, dev, card: str) -> dict:
    """Phase 15: the hygiene pass (in a process of its own below this one)."""
    _hygiene(card)
    return {}


def _group_bench(torch, np, dev, card: str) -> dict:
    """Phase 16: the bench line and records; row 1's launch timed here, in
    turns with the bench line's block decode."""
    from csnappy_tpu_torch.ops import decode_fused
    from csnappy_tpu_torch.tools.timing import time_ms

    urls = _data()[0]
    comp, lens = _main_batch(torch, urls)[-2:]
    args = _launch_args(torch, dev, comp, lens)
    gbps = _bench_records(urls, lambda: time_ms(lambda: decode_fused._launch(
        decode_fused.decode_blocks, *args, BS)))
    return {"values": {"bench_block_decode_GBps": gbps}}


# the phase groups, in order, each run in a child process of its own
# (``--phase GROUP``): its phases and what runs them; phase 1 (the build)
# and 17 (the result) are the parent's
GROUPS = {"decode": ((2, 3, 4, 5), _group_decode), "streams": ((6,), _group_streams),
          "container": ((7, 8, 9), _group_container), "movebench": ((10,), _group_movebench),
          "primitives": ((11,), _group_primitives), "probes": ((12,), _group_probes),
          "kernel_lib": ((13,), _group_kernel_lib), "scaleout": ((14,), _group_scaleout),
          "hygiene": ((15,), _group_hygiene), "bench": ((16,), _group_bench)}
GROUP_LIMIT_S = 600             # a child's own time limit (the hygiene pass: its budget more)
RESULT = "phase_result"         # the key of a child's result line
TAIL = 3000                     # what the parent prints of a failed child's output


def _child(group: str, torch) -> int:
    """Run one phase group in this process; print its ``[phase]`` line and
    its result line (``{"phase_result": {...}}``): its rows, the values
    the parent merges, its seconds and its traces."""
    import numpy as np

    from csnappy_tpu_torch.tools import timing

    card = timing.smi("name,power.limit,clocks.max.sm")
    t0 = time.perf_counter()
    out = GROUPS[group][1](torch, np, torch.device("cuda"), card)
    sec = time.perf_counter() - t0
    tr = dict(timing.traces)
    print(f"[phase] {group}: {sec:.1f} s, traces {tr['taken']}, retaken {tr['retaken']}, "
          f"lost {tr['lost']}", flush=True)
    print(json.dumps({RESULT: {"group": group, "rows": out.get("rows", []),
                               "annotate": out.get("annotate", {}),
                               "values": out.get("values", {}), "seconds": sec,
                               "traces": tr}}), flush=True)
    return 0


def _spawn(group: str, limit: float) -> tuple:
    """Run ``chip_smoke.py --phase GROUP`` in a new session, echoing its
    output and its errors line by line as they come (but the result line),
    and kill its whole process group at ``limit`` seconds and when it ends.
    Returns (exit code, or None where it was cut; its output, its errors'
    lines among the output's where they came)."""
    import os
    import signal
    import threading

    p = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", group],
                         cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    lines = []                  # list.append is atomic: the two pumps share it

    def pump(stream, echo):
        for line in stream:
            lines.append(line)
            if not line.startswith('{"' + RESULT):
                print(line, end="", file=echo, flush=True)

    pumps = [threading.Thread(target=pump, args=(p.stdout, sys.stdout), daemon=True),
             threading.Thread(target=pump, args=(p.stderr, sys.stderr), daemon=True)]
    for t in pumps:
        t.start()
    try:
        rc = p.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
        for t in pumps:
            t.join(timeout=30)
    return rc, "".join(lines)


def result_of(text: str):
    """A child's result from its output: the one ``{"phase_result": ...}``
    line, or None."""
    found = [json.loads(line)[RESULT] for line in text.splitlines()
             if line.startswith('{"' + RESULT)]
    return found[0] if len(found) == 1 else None


def run_groups(runner, groups=tuple(GROUPS)) -> tuple[int, list]:
    """Run each group through ``runner(group, limit)`` -> (exit code or None
    where cut, output), in order.  A child that exits non-zero, was cut or
    printed no result line stops the run: its last ``TAIL`` characters are
    printed and (1, results so far) returned; else (0, results)."""
    results = []
    for group in groups:
        limit = GROUP_LIMIT_S + (HYGIENE_SECONDS + 600 if group == "hygiene" else 0)
        rc, text = runner(group, limit)
        res = result_of(text) if rc == 0 else None
        if res is None:
            why = (f"was cut at its {limit} s limit" if rc is None else
                   f"exited {rc}" if rc else "printed no result line")
            print(f"chip_smoke: phase group {group} {why}; its last {TAIL} characters:\n"
                  f"{text[-TAIL:]}", flush=True)
            return 1, results
        results.append(res)
    return 0, results


def merge(results: list) -> list:
    """The ``kernels`` rows of the children's results, in group order, as
    the single process built them: each group's annotations (a field, by
    row name) go on the rows of the groups before it, then its rows follow."""
    rows = []
    for res in results:
        for field, by_name in res["annotate"].items():
            for row in rows:
                if row["name"] in by_name:
                    row[field] = by_name[row["name"]]
        rows += res["rows"]
    return rows


def chain_lines(rows: list, step: float, clock: str) -> list[str]:
    """Each serial chain in units of one measured ``walk_smem`` step
    (``step`` SM cycles at the max SM clock ``clock``), and
    ``decode_stream.cu``'s links."""
    step_ms = step / (float(clock.split()[0]) * 1e3)      # cycles at the max SM clock
    out = []
    for row in rows:
        if "chain_links" in row:
            out.append(
                f"[chain] {row['name']}: chunks chained and segments that waited on a flag, by "
                f"stream {row['chain_links']}; each link a device-memory word, "
                f"{ {k: [round(v['chunk_us'], 3), round(v['segment_us'], 3)] for k, v in row['streams'].items()} } "
                f"us a chunk and a segment; the kernels {row['ms']:.4f} ms on urls.10K.snappy")
        if "chain_steps" in row and row["route"] == "cuda":
            out.append(
                f"[chain] {row['name']}: {row['chain_steps']} serial steps x one walk_smem step "
                f"({step:.2f} SM cycles at {clock}: a dependent shared load and four integer "
                f"operations, not a floor) = {row['chain_steps'] * step_ms:.4f} ms; the kernel "
                f"{row['ms']:.4f} ms")
    return out


def trace_totals(results: list) -> dict:
    """The children's seconds and traces summed."""
    out = {"seconds": 0.0, "taken": 0, "retaken": 0, "lost": 0}
    for res in results:
        out["seconds"] += res["seconds"]
        for k in ("taken", "retaken", "lost"):
            out[k] += res["traces"][k]
    return out


def main(argv=None, runner=_spawn) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phase", choices=tuple(GROUPS),
                    help="run one phase group in this process (what the parent runs each child as)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "csnappy_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: csnappy_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.phase:
        return _child(args.phase, torch)

    from csnappy_tpu_torch.ops import _build
    from csnappy_tpu_torch.tools.timing import smi

    card = smi("name,power.limit,clocks.max.sm")
    clock = card.split(",")[2].strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}", flush=True)

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.CUDA_NAMES:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # ------------------------------------------------- 2-16. the children
    rc, results = run_groups(runner)
    if rc:
        return rc
    rows = merge(results)
    values = {k: v for res in results for k, v in res["values"].items()}
    for line in chain_lines(rows, values["walk_smem_cycles"], clock):
        print(line, flush=True)
    row1 = next(r for r in rows if r["name"] == "decode_blocks")
    print(f"[bench] block decode {values['bench_block_decode_GBps']} GB/s beside row 1's "
          f"{row1['GBps']:.4f} GB/s (phase 5, another process)", flush=True)

    # --------------------------------------------------------- 17. result
    tot = trace_totals(results)
    print(f"[phase] total: {tot['seconds']:.1f} s in {len(results)} children, traces "
          f"{tot['taken']}, retaken {tot['retaken']}, lost {tot['lost']}; the whole run "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
