#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--pool 50000] [--max-iters 200]
                          [--serve-batch 8] [--prompt-len 2048] [--gen 32]

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds every kernel from ``src/repro_torch/kernels/csrc`` with nvcc (one
   nvcc per source, all started together), and counts the tensor-core
   (HMMA) instructions of ``flash_attention`` (forward and backward),
   ``ssd_scan`` (forward and backward) and ``pairwise_dist`` in their
   SASS, prints the shared memory of each of the SSD backward's launches,
   and counts the attention forward's and the two backwards' ``wgmma``
   (HGMMA) and TMA tensor-load (UTMALDG) instructions: none of any fails
   the run.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, the JAX package's test grids and the tile edges of
   the kernels, and after the main paths again at every shape they gave
   it; the per-chunk states ``ssd_scan`` leaves in its scratch against
   the plain three-pass split (``ref.ssd_scan_passes_ref``); and
   ``margin_head`` on a maximal column copied into another slice (top1
   the first copy, margin exactly 0).  ``pairwise_sqdist`` is held at the
   JAX package's atol 1e-5 on that package's grid, and elsewhere against
   a float64 computation of the same distances: its error at most twice
   the plain fp32 version's.  ``flash_attention`` on its ``wgmma`` route
   (bf16 at hd 64, 80 and 128) also its log-sum-exp against the plain one
   (``ref.flash_attention_lse_ref``, atol 1e-3), and two calls on the
   same inputs bit-equal.  ``flash_attention``'s backward kernel (run
   through ``ops.attention`` with grad) against ``torch.autograd.grad``
   through the plain version, on its ``wgmma`` route (bf16 at hd 64, 80,
   128 and 256) also against its arithmetic step by step
   (``ref.flash_attention_bwd_tiled_ref``, atol = rtol = 1e-2), and two
   calls on the same inputs bit-equal, on ``FLASH_BWD_GRID`` and at every
   shape the training paths gave it.  The pair in the mask's shifted frame
   (``q_offset``, ``kv_start``): qwen2-1.5b's training shape as 16 "model"
   ranks split its sequence (B 8, H 12/2, 128 queries at each of the 16
   offsets over 2,048 keys, hd 128; bf16, fp32 at three offsets), gemma3-4b's
   halo frame (2,048 queries at offset 1,024 over 3,072 keys, hd 256,
   window and kv_start 1,024), each at the tolerances above and keys below
   ``kv_start`` without a gradient; the 16 blocks on one sequence put back
   together against the whole sequence's pair (output and dQ at 3e-2, dK
   and dV summed over the blocks, their error printed).  ``ssd_scan``'s
   backward kernel on the
   forward kernel's per-chunk states against its split plain version
   (``ref.ssd_scan_bwd_passes_ref``) and against ``torch.autograd.grad``
   through the plain scan, with a final-state gradient and without, and
   two calls bit-equal, on ``SSD_BWD_GRID`` (the forward's grid but its
   largest case, and N 8) and at every shape the training paths gave it
   (mamba2-1.3b's and zamba2-2.7b's).
4. Runs two MCAL campaigns through the port's entry points
   (``run_mcal(LiveTask(...))``), one with the margin M(.) and one with
   k-center, on ``make_classification(50_000, 10 classes, dim 32)`` — the
   data ``python -m repro.launch.label --live --pool 50000`` builds — on
   the default route: pool passes through the paged sweep runtime, each
   retrain a replayed CUDA graph.  Each is run again with the eager retrain
   loop and must end the same way.  Each of the task's passes is timed up
   to a device synchronize, which gives the campaign's seconds by phase.
5. Runs the margin campaign once more through
   ``repro_torch.launch.label.run_campaign`` with ``sweep_async``,
   ``fit_async``, ``fit_resident`` and a trace, preempted every two
   iterations and resumed from its state file: its trace must diff clean
   against the first margin campaign's and its result equal it.  Holds one
   retrain per bucket the campaigns used through the CUDA graph against
   the eager loop (params and losses bit-equal; capture, replay and eager
   seconds), and the paged rank, feature and top-k sinks against the
   engine's unpaged pass, exactly.
6. Runs the k-center campaign again with the distances on their plain
   version (both routes' iterations, |S| and distance calls are printed);
   the paper-scale replay campaigns through ``make_emulated_task``
   (cifar10/resnet18 at 50,000 rows with margin and with k-center, which
   must launch ``pairwise_sqdist``, and the imagenet bail-out at
   1,200,000 rows), each ending as the reference's; the live margin
   campaign buying its labels from a noisy annotation service (5
   workers, noise 0.2, 3 votes, Dawid-Skene on the card) through the
   launcher, uninterrupted and preempted every two iterations (the
   traces diff clean, the results are equal, ``margin_head`` launches);
   and the vote aggregator at (50,000 items, 5 workers, 100 classes, 3
   votes) against the float64 host oracles: majority exact, Dawid-Skene
   within the JAX package's atol 1e-4 with identical labels, seconds per
   aggregation.
7. Runs the fleet (``repro_torch.launch.orchestrator.build_fleet``): eight
   live campaigns, t0-t7 (priority i % 3, seed i, eps 0.05 + 0.01 (i % 4),
   k-center on the odd ones), sharing one engine bundle on the card,
   concurrently and then serially — every tenant's trace diffs clean
   between the two, t0 and t1 alone on private engines diff clean against
   theirs, each ``fit_plan`` bucket is captured once; the same eight as
   sessions of one noisy annotation service under a global ceiling of half
   their bootstrap spend, twice — the cascade walks pause, shrink_votes
   and force_commit the same way both times, and every tenant's votes
   equal its ``buy_labels`` charges; the noisy margin campaign through the
   launcher (async) fault-free, under the ``--chaos`` plan (every site
   fires), killed at iteration 2 with ``--autosave`` and resumed, with
   metrics, an SLO and ``--prom`` (the reference's spans, fit spans
   fenced; its wall against the plain one), and with ``--profile`` over
   iteration 1 (the Chrome trace holds ``margin_head``'s kernel): each
   diffs clean against the fault-free run.
   Then architecture selection (``select_architecture``): three live MLP
   candidates on the same data (``LiveTask`` defaults, hidden 32, 64 and
   128, each with its own engines), with margin and with k-center, each
   synchronously and with ``fit_async`` and ``sweep_async`` (every
   candidate's retrain at once, each engine capturing its own graphs) —
   the two runs end alike, each engine captures each bucket once, the
   error meets the target — and the paper's cnn18/resnet18/resnet50
   replay candidates on fashion, cifar10 and cifar100 (margin) and cifar10
   (k-center), each ending as the reference's selection, printed beside
   the paper's Table 1.
8. Serves zamba2-2.7b (full config: 54 layers, d_model 2560, bf16 weights
   from ``Model.init(seed 0)``) through ``ServeEngine``: 8 requests of
   2,048 random tokens are scored (``score``, the fp32 LM head through
   ``margin_head``), 32 rows are scored by ``score_pool`` in pages of 8
   (each page's stats equal ``score`` on its batch), and 32 tokens are
   generated greedily; the first equals the argmax of the forward pass's
   last logits.  Prints init seconds, prefill tokens/s, decode tokens/s,
   score and score_pool rows/s and peak device memory; profiles one score
   pass, one forward pass and one decode step, and times the score pass's
   cast of the bf16 LM head to fp32.  Then the dense LM labeler, each at
   its full config with bf16 weights from ``Model.init(seed 0)``, through
   the same passes: qwen2-1.5b (28 layers, GQA 12:2 at hd 128, vocab
   151,936; 32 tokens generated), followed by MCAL's pool pass over a
   1,024 x 256-token int32 pool (seed 0) through ``PoolScoringEngine``
   (microbatch 64): the top-100 by margin and the L(.) ranking, unpaged
   and through ``PoolSweepRunner`` in pages of 256, paged equal to
   unpaged in index order, the first microbatch's statistics against the
   host oracle ``score_pool_reference``, and the head cast's share; and
   gemma3-4b (34 layers, GQA 8:4 at hd 256, a 1,024-token window on five
   layers of six, a tied 262,144-row head; 16 tokens generated), whose
   attention must run with both windows, and then trained (below).  Then
   the rest of the zoo
   through the same passes: mamba2-1.3b (48 Mamba2 layers, ``ssd_scan``
   at state N 128, vocab 50,280; full config) and its pool pass as
   qwen2's; dbrx-132b at full width (d_model 6,144, GQA 48:8 at hd 128,
   16 experts top-4 at d_ff 10,752, capacity factor 1.25, vocab 100,352)
   cut to ``DBRX_LAYERS`` = 1 of its 40 layers (6.5 GB of bf16 weights a
   layer); internvl2-26b (GQA 48:8 at hd 128, vocab 92,672; full width,
   cut to ``INTERNVL2_LAYERS`` = 6 of its 48 layers) with 1,024 random
   fp32 patch embeddings a request (seed
   0) before its prompt, so its attention runs over 3,072 positions and
   its cache holds ``1,024 + prompt + gen + 8``; and whisper-tiny (the
   audio family: 4 encoder and 4 decoder layers, d_model 384, hd 64,
   vocab 51,872; full config) with 1,500 random fp32 frame embeddings a
   request and a pool row (seed 0), its attention the encoder's T 1,500,
   the decoder's and the cross-attention's 2,048 x 1,500.
   Training, each from the served bf16 weights through ``Trainer``
   (``train_lm``): zamba2-2.7b at full width and depth with bf16 first
   moments, after its serving passes; after their pool passes, qwen2-1.5b
   and mamba2-1.3b at their full configs (``remat="layer"``,
   ``logits_chunk`` 16,384): 6 steps of 8 x 2,048 tokens of
   ``make_lm_tokens`` through ``ShardedLoader``, ``paper_steps`` from lr
   1e-4, no checkpoint: the losses finite and falling, each backward kernel
   once a step for each launch of its forward in a forward pass (the SSD
   scan's once a Mamba2 layer, attention's once a layer or a zamba2
   shared-block application); gemma3-4b likewise at full width, its
   served weights cut to ``GEMMA3_TRAIN_LAYERS`` = 12 of its 34 layers
   (two whole 5:1 periods: ten local layers, two global), 3 steps, the
   attention backward at hd 256 with both windows, 0 and 1,024, and the
   loss alone timed for its share of a step; and whisper-tiny on batches
   of tokens, labels and 1,500 fp32 frames a row, 4 steps checkpointed
   every 2, then a fresh ``Trainer`` resumed from step 4 to 6 on the same
   batch generator: the restored state bit-equal to the saved one and the
   resumed losses bit-equal to an uninterrupted run's over the same
   batches.
   The kernels' launch counts are zeroed just before each main-path pass
   (each campaign, the launcher campaign, the replay and noisy campaigns,
   the fleets, the chaos and instrumented campaigns, each selection run,
   each serving pass and each pool pass: ``flash_attention`` 9 times a
   zamba2 forward, once a layer in the others (28 qwen2-1.5b, 34
   gemma3-4b, 1 dbrx-132b, 6 internvl2-26b, 12 whisper-tiny: 4 encoder,
   8 decoder), ``ssd_scan`` 54 times a zamba2 forward and 48 a
   mamba2-1.3b one, the backward kernels never when serving and once a
   step for each launch of their forwards in a forward pass when training)
   and read just after it; a kernel of a path that
   was never launched there fails the run.  Each phase's seconds are
   printed.
9. Times each kernel at the largest shape each main path gave it
   (``ssd_scan`` at zamba2's N 64 and at mamba2's and its pool pass's N
   128), its plain version and (where one PyTorch call computes the same
   function:
   ``scaled_dot_product_attention`` with ``enable_gqa`` and, for a
   window, a boolean mask) that call, with CUDA events: the median of 30
   single-call timings after a warm-up, host launch gaps included.
   ``device_ms`` (``plain_device_ms``, ``library_device_ms``) times calls
   queued back to back between two CUDA events, with no host wait
   between them; ``device_ms_by_launch`` stays empty (each launch's own
   time: ``tools/time_attention_bwd.py`` and ``tools/time_ssd_bwd.py``).
   ``flash_attention`` and its backward are also timed at the last rank
   block of the 16-way split and at the halo frame (SDPA with the explicit
   boolean mask as the library's time).
   Every check's and timing row's wall seconds are printed; their random
   inputs are drawn on the card (seeded ``torch.Generator``s).
   The bound is the larger of the bytes the function must move over 3.35
   TB/s and its flops over the peak for the work's type: 67 TFLOP/s for
   fp32 on the CUDA cores, 989 TFLOP/s for bf16 on the tensor cores
   (``flash_attention``, ``ssd_scan``, and ``pairwise_sqdist``'s six
   bf16 products), H100 SXM data-sheet peaks.  The backward kernel at
   whisper's and qwen2's training shapes, beside autograd's backward
   through the plain version and SDPA's backward, bound by 2.5 times the
   forward's operations or its bytes; at zamba2's (hd 80, on the wgmma
   route at two padded panels) and gemma3-4b's local and global layers'
   (hd 256) too.  The SSD backward at zamba2's and
   mamba2's training shapes, beside autograd's backward through the plain
   scan (no library call computes it), bound by its products at the bf16
   peak or its bytes (the forward's per-chunk states included).
10. The mesh phase, on a one-rank NCCL group (one card): (a) the
   launcher campaign of step 5 over ``--mesh data=1`` in a child process
   of this script, after the same campaign unmeshed in that process: its
   result equal to the unmeshed ones, its trace clean against the
   synchronous campaign's, its seconds by phase beside the unmeshed
   run's; (b) dbrx-132b's layer 0 at full width through every sharded MoE
   route (replicate + psum with the gather route in bf16 and int8 and
   the psum FFN mode, a2a with both gathers), 8 x 256 tokens at capacity
   factor 8, against the local block; (c) two int8 error-feedback
   data-parallel steps of qwen2-1.5b at its full config from the served
   weights, step 1's loss against a plain step's, every residual within
   half its scale, the peak memory; (d) halo attention at gemma3-4b's
   local layers' shape against the windowed blockwise attention: it runs
   the ``flash_attention`` kernel once, in the halo's frame, and its
   seconds are printed beside the blockwise attention's.
   The ``sharded`` phase, on the same group, every collective of the
   policy taken over its axes of one rank (``force``; each layer computes
   on its blocks over "model", tensor-parallel, and gathers its storage
   dims over "data"): (a) four steps of
   ``make_sharded_train_step`` at qwen2-1.5b's full config under
   ``fsdp_tp`` and four under ``tp`` from the served weights (8 x 2,048
   tokens), step 1's loss the plain step's to the bit (four plain steps
   from the same weights),
   seconds, tokens/s and peak memory beside theirs and the medians' ratio,
   the attention kernel and its backward launched; (b) ``Trainer`` and
   ``ShardedLoader`` on the mesh at whisper-tiny's full config, four steps
   checkpointed at step 2, a second run stopped at step 2 and a fresh
   ``Trainer`` resumed from it through ``restore(shardings=)``: bit-equal
   to the uninterrupted meshed run (its heads, MLP columns and vocabulary
   computed as blocks over "model");
   (c) ``ServeEngine(mesh=, policy="tp")`` at qwen2-1.5b's full config:
   ``score`` and a ``score_pool`` top-k on 64 rows and ``generate`` for 8
   prompts of 128 tokens, 16 steps, against the unmeshed engine's (stats
   at the pool pass's tolerance, top1, top-k and tokens exactly; the
   meshed cache split along the sequence, decoded by flash-decode), each
   pass's seconds beside the unmeshed one's and their ratio,
   ``margin_head`` launched; (d) (a) at mamba2-1.3b's full config, three
   steps a policy, its Mamba2 mixers on their heads' block over "model"
   (``ssd_scan`` and its backward launched); (e) (c) at mamba2-1.3b's and
   zamba2-2.7b's full configs (their state caches split as the
   reference's rule splits them, ``ssd_scan`` launched), printing whether
   ``score``'s stats are the unmeshed ones to the bit; (f) with (a), four
   steps under ``fsdp_tp_seq`` (the sequence split over "model": one block
   at offset 0, K and V gathered over the axis, attention at ``q_offset``,
   the loss's share summed over it), step 1's loss the plain step's to the
   bit, its step time over the plain one's, the attention kernel pair
   launched (counted apart, path ``sharded_train_seq``), and with (d)
   four mamba2-1.3b steps under ``fsdp_tp_seq`` (its conv halo gathered
   along the axis; one block, so no state to exchange), step 1's loss the
   plain step's to the bit, ``ssd_scan`` and its backward launched
   (counted apart, path ``sharded_train_mamba2_seq``); (g)
   ``ServeEngine(mesh=, policy="fsdp_tp_seq")`` at zamba2-2.7b's and
   whisper-tiny's full configs: ``prefill`` of 8 prompts (whisper's
   1,500 frames split too), its logits and every cache leaf against the
   unmeshed engine's (2^-7 relative plus 1e-3 of the largest, bit-equality
   printed), ``flash_attention`` (and zamba2's ``ssd_scan``) launched.  The
   SSD kernels are also checked and timed at a "model" rank's head block
   of those two models on the production mesh (4 and 5 heads at B 8 x T
   2,048), and chained through the incoming state ``h0`` (and back
   through its gradient ``dh0``) over mamba2-1.3b's and zamba2-2.7b's
   training shapes cut into 4 and 16 chunk-aligned blocks against the
   whole sequence (``check_ssd_offsets``); the pair with ``h0`` is timed
   at a 16-way block (T 128).
   The ``launch_tools`` phase (the twins of the reference's launch
   analysis tools, ``repro_torch.launch.{roofline,fitsproof,dryrun}``):
   (a) after qwen2-1.5b's training, one forward and one more training step
   at its shape (8 x 2,048 tokens, ``remat="layer"``, ``logits_chunk``
   16,384) under ``FlopCounterMode``, each hand-written kernel launch added
   at its bound column's operations (a backward 2.5 times its forward):
   the forward within 20% of the roofline's ``forward_flops``, the step
   within 20% of ``forward_flops x (3 + 1) + 2 B T D V x 3``; the
   roofline's ``model_flops`` and the ``mfu`` its median step implies at
   989 TFLOP/s; one forward each of mamba2-1.3b and zamba2-2.7b counted
   the same way, the ratio printed only; (b) the fits-proof on the card's
   memory: the (arch x cell) rows that fit at 0.9 of it and at 0.9 of the
   reference's 16 GB, on each mesh kind; (c) ``python -m
   repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh
   single`` in a child process (a fake 256-rank world on the host, at most
   150 s): its FLOPs a device within 20% of the tensor-parallel design's
   analytic count (``dryrun.expected_train_flops``), printed beside the
   roofline's ``flops_local``, an all-gather counted, its temporaries
   under the card's memory; then qwen1.5-4b ``decode_32k`` the same way
   (a decode step against a 32k cache split along the sequence), its
   arguments and temporaries within 0.9 of the card's memory.
11. Prints one ``{"kernels": [...]}`` line (each kernel with the launch
   names the profiled passes saw under its prefix; where the profiler kept
   ``flash_attention``'s, one must be ``flash_attention_wgmma_kernel``),
   the card's line again, and last ``{"ok": true, "device": {...}}``.  Any
   failed check exits non-zero before a result is printed.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
# depths cut to keep the script inside its time limit, every width the
# config's: host init of random weights is most of these two models' time
# (6.5 GB of bf16 weights a dbrx-132b layer, 0.8 GB an internvl2-26b one)
DBRX_LAYERS = 1           # of 40
INTERNVL2_LAYERS = 6      # of 48 (12 before the ssm and hybrid training)
# gemma3-4b trained on two whole 5:1 periods of the served weights (ten
# local layers at window 1,024, two global), 3 steps (4 took the script
# past 1,100 s of the 1,200 allowed on one host).  Its tied head is
# the embedding at the reference's init (std 1): logits in the thousands,
# a loss near 2,530 that lr 1e-4 moves by less than the batches' spread
# (about 2); Adam at 1e-2 shrinks the final norm's scale by 1% a step
GEMMA3_TRAIN_LAYERS = 12  # of 34
GEMMA3_TRAIN_STEPS = 3
GEMMA3_TRAIN_LR = 1e-2
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# the card's name and power limit (nvidia-smi), printed beside each rate
CARD = "card not read"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def normal(torch, shape, g, scale: float = 1.0):
    """Normal fp32 values drawn on the card from the generator ``g`` (a
    host draw of a full LM head took seconds a matrix)."""
    return torch.randn(shape, generator=g, device="cuda") * scale


def card_generator(torch, seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def timed(label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"seconds {label}: {time.perf_counter() - t0:.1f} ({CARD})",
          flush=True)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20) -> float:
    """Time per call of ``reps`` calls queued back to back between two
    CUDA events, no host wait between them: the card's time for the call
    wherever its launches outlast the host's issue of the next; a call of
    a few microseconds reads the host's issue rate instead."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def launch_ms(torch, fn, kernel: str, reps: int = 20) -> dict:
    """Device time per call of each launch whose name carries ``kernel``
    (the backwards' passes, for ``tools/time_{attention,ssd}_bwd.py``),
    from the profiler's CUDA trace.  Late in a long process the trace can
    lose records: a name whose count is not a whole multiple of ``reps``
    is None, and printed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if kernel not in e.key or t <= 0:
            continue
        out[e.key] = None if e.count % reps else t / reps / 1e3
        if out[e.key] is None:
            print(f"launch_ms {kernel}: the trace kept {e.count} records "
                  f"of {e.key[:60]} over {reps} calls", flush=True)
    return out


def sass_instructions(nvcc: str, lib: Path, ops=("HMMA",)) -> dict:
    """How many instructions of each opcode in ``ops`` (HMMA: mma.sync;
    HGMMA: wgmma; UTMALDG: a TMA tensor load) the library's SASS holds,
    from the toolkit's cuobjdump beside nvcc; -1 each where it is
    missing."""
    tool = Path(nvcc).with_name("cuobjdump")
    if not tool.exists():
        return {op: -1 for op in ops}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout.splitlines()
    return {op: sum(op in line for line in sass) for op in ops}


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the campaigns' shape, the JAX package's test grid, the zamba2-2.7b LM
# head at 8 and 64 requests, and the kernel's slice edges: V = 32000 +- 1
# (off the 128-column slices and the 4-column vector loads), one request
MARGIN_GRID = [(2048, 64, 10), (128, 64, 512), (200, 48, 1000),
               (65, 32, 257), (256, 128, 4096), (8, 2560, 32000),
               (64, 2560, 32000), (8, 2560, 31999), (8, 2560, 32001),
               (1, 2560, 32000), (8, 1536, 151936), (64, 1536, 151936),
               (8, 2560, 262144)]
# (T, D, V, first, copy): each row's maximal column copied into a later
# slice, far off and across one slice edge; then into the last (ragged)
# slice of qwen2-1.5b's head (1,187 slices merged) and the last of
# gemma3-4b's (2,048)
MARGIN_DUP_GRID = [(8, 2560, 32000, 7, 20000), (8, 2560, 32000, 127, 128),
                   (8, 1536, 151936, 100, 151935),
                   (8, 2560, 262144, 5, 262143)]


def check_margin_head(torch, np, mh, ref, cases):
    """Kernel vs plain at each (T, D, V), fp32 and bf16; returns the max
    abs error in fp32."""
    gen = card_generator(torch, 0)
    worst = 0.0
    dtypes = [(torch.float32, 5e-5), (torch.bfloat16, 5e-2)]
    for T, D, V in cases:
        h32 = normal(torch, (T, D), gen)
        w32 = normal(torch, (D, V), gen, 0.1)
        for dtype, tol in dtypes:
            h, w = h32.to(dtype), w32.to(dtype)
            got = mh.margin_head(h, w)
            want = ref.margin_head_ref(h, w)
            torch.cuda.synchronize()
            errs = [float((g - r).abs().max()) for g, r in zip(got[:3],
                                                               want[:3])]
            # the JAX package's test tolerances (assert_allclose with
            # atol = rtol = tol; entropy 10x)
            for name, g, r, lim in zip(("margin", "entropy", "max_logprob"),
                                       got, want, (tol, tol * 10, tol)):
                if not bool(((g - r).abs() <= lim + lim * r.abs()).all()):
                    fail(f"margin_head {name} at {(T, D, V)} {dtype}: "
                         f"beyond atol = rtol = {lim}")
            if dtype == torch.float32:
                if not torch.equal(got[3], want[3]):
                    fail(f"margin_head top1 differs at {(T, D, V)}")
                worst = max(worst, *errs)
            print(f"margin_head {(T, D, V)} {str(dtype)[6:]}: max abs err "
                  f"margin {errs[0]:.3g} entropy {errs[1]:.3g} "
                  f"max_logprob {errs[2]:.3g} ok", flush=True)
    return worst


def check_margin_ties(torch, np, mh, ref, cases):
    """A maximal column and its copy in another slice: the kernel sums
    every column in one order, so they tie exactly, top1 is the first and
    the margin 0 (normal inputs); on integer inputs every logit is exact
    and the plain version ties the same way."""
    for T, D, V, first, copy in cases:
        g = card_generator(torch, V + first)
        for kind in ("normal", "integer"):
            if kind == "integer":
                h = torch.randint(1, 4, (T, D), generator=g,
                                  device="cuda").float()
                w = torch.randint(-2, 3, (D, V), generator=g,
                                  device="cuda").float()
                w[:, first] = w[:, copy] = 3.0
            else:
                h = normal(torch, (T, D), g).abs()
                w = normal(torch, (D, V), g, 0.1)
                w[:, first] = w[:, copy] = 1.0
            got, want = mh.margin_head(h, w), ref.margin_head_ref(h, w)
            torch.cuda.synchronize()
            if not (bool((got[3] == first).all())
                    and bool((got[0] == 0).all())):
                fail(f"margin_head tie at {(T, D, V, first, copy)} {kind}: "
                     f"top1 {got[3].tolist()} margin {got[0].tolist()}")
            if kind == "integer" and not torch.equal(got[3], want[3]):
                fail(f"margin_head tie at {(T, D, V, first, copy)}: top1 "
                     f"differs from the plain version's {want[3].tolist()}")
            print(f"margin_head tie {(T, D, V, first, copy)} {kind}: top1 "
                  f"{first}, margin 0 ok", flush=True)


# the JAX package's grid for its kernel (tests/test_selection_device.py),
# held at its tolerance, atol 1e-5
PAIRWISE_REF_GRID = [(5, 3, 4), (64, 16, 8), (130, 9, 33), (257, 128, 16)]
# N = the padded k-center pool of a 50,000-row campaign; M = pow2(|B|)
# for |B| up to 4,096 anchors, then the emulated campaign's (conf, u)
# features (D = 2), then N and M off the kernel's 128 x 128 tiles, D off
# its 16-deep k steps, and D over its 64-wide chunks (130: also off its
# 16-byte pieces)
PAIRWISE_GRID = [(65536, m, 64) for m in (512, 1024, 2048, 4096)] + [
    (65536, 4096, 2), (65536, 8192, 2), (130, 9, 33), (65537, 2049, 64),
    (300, 130, 33), (300, 1100, 100), (257, 140, 130)]
PAIRWISE_INT_GRID = [(1025, 17, 32), (300, 8, 2), (4099, 513, 64),
                     (513, 1100, 100)]


def check_pairwise(torch, np, pd, ref, cases, int_cases=(),
                   ref_cases=()):
    """Kernel vs plain on normal inputs: at ``ref_cases`` within the JAX
    package's atol 1e-5 (and assert_allclose's default rtol 1e-7); at
    ``cases``, where 1e-5 is below the plain fp32 version's own rounding at
    D = 64, both against a float64 computation of the same distances: the
    kernel's max abs error at most twice the plain version's.  Exactly on
    integer-valued inputs.  Returns the max abs difference from the plain
    version on the normal inputs."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for N, M, D in [*ref_cases, *cases]:
        x = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                            device="cuda")
        c = torch.as_tensor(rng.normal(size=(M, D)).astype(np.float32),
                            device="cuda")
        got, want = pd.pairwise_sqdist(x, c), ref.pairwise_sqdist_ref(x, c)
        err = float((got - want).abs().max())
        if got.shape != (N, M) or bool((got < 0).any()):
            fail(f"pairwise_sqdist at {(N, M, D)}: bad output")
        if (N, M, D) in ref_cases:
            if not bool(((got - want).abs() <= 1e-5 + 1e-7 * want.abs())
                        .all()):
                fail(f"pairwise_sqdist at {(N, M, D)}: err {err} beyond "
                     f"atol 1e-5")
            note = "within atol 1e-5"
        else:
            x64, c64 = x.double(), c.double()
            exact = torch.clamp((x64 * x64).sum(-1)[:, None]
                                - 2.0 * (x64 @ c64.T)
                                + (c64 * c64).sum(-1)[None, :], min=0.0)
            e_kern = float((got.double() - exact).abs().max())
            e_plain = float((want.double() - exact).abs().max())
            del x64, c64, exact
            if not e_kern <= 2.0 * e_plain:
                fail(f"pairwise_sqdist at {(N, M, D)}: error against fp64 "
                     f"{e_kern} > twice the plain version's {e_plain}")
            note = (f"against fp64: kernel {e_kern:.3g}, plain "
                    f"{e_plain:.3g} (limit {2 * e_plain:.3g})")
        worst = max(worst, err)
        del got, want
        torch.cuda.empty_cache()
        print(f"pairwise_sqdist {(N, M, D)}: max abs diff from plain "
              f"{err:.3g}, {note} ok", flush=True)
    for N, M, D in int_cases:
        x = torch.as_tensor(rng.integers(0, 8, size=(N, D)).astype(
            np.float32), device="cuda")
        c = torch.as_tensor(rng.integers(0, 8, size=(M, D)).astype(
            np.float32), device="cuda")
        if not torch.equal(pd.pairwise_sqdist(x, c),
                           ref.pairwise_sqdist_ref(x, c)):
            fail(f"pairwise_sqdist not exact on the integer grid {(N, M, D)}")
        print(f"pairwise_sqdist integer grid {(N, M, D)}: exact ok",
              flush=True)
    return worst


# the JAX package's grid (tests/test_kernels.py:40-46), a window without
# causal, zamba2-2.7b's serving shape, and the tile edges of the kernel: Tq
# and Tk off its 128-row query and 64-key tiles, GQA group 4, windows that
# cross a tile border, hd 8 padded to the mma's k = 16; then the dense
# LMs' head dims: qwen2-1.5b's GQA 12:2 at hd 128 (serving, pool pass),
# gemma3-4b's 8:4 at hd 256 on a local (window 1,024) and a global layer,
# and the edges of the 64-row blocks and 32-key tiles: (B, H, Hk, Tq, Tk,
# hd, causal, window)
FLASH_GRID = [(2, 4, 2, 128, 128, 32, True, 0), (1, 4, 4, 96, 96, 16, True, 0),
              (2, 8, 2, 64, 64, 32, True, 24),
              (1, 2, 1, 50, 130, 16, False, 0), (1, 6, 3, 33, 77, 8, True, 0),
              (1, 2, 1, 70, 70, 16, False, 24),
              (8, 32, 32, 2048, 2048, 80, True, 0),
              (1, 4, 1, 129, 129, 80, True, 0),
              (2, 8, 2, 200, 333, 16, True, 0),
              (2, 8, 2, 200, 333, 16, False, 0),
              (1, 8, 2, 256, 256, 80, True, 0),
              (1, 4, 2, 300, 300, 32, True, 100),
              (1, 2, 1, 190, 190, 80, False, 70),
              (2, 4, 2, 150, 150, 8, True, 0),
              (8, 12, 2, 2048, 2048, 128, True, 0),
              (64, 12, 2, 256, 256, 128, True, 0),
              (8, 8, 4, 2048, 2048, 256, True, 1024),
              (8, 8, 4, 2048, 2048, 256, True, 0),
              (1, 4, 1, 129, 200, 128, True, 0),
              (2, 6, 2, 190, 333, 128, False, 0),
              (1, 4, 2, 300, 300, 256, True, 100),
              (1, 2, 1, 190, 190, 256, False, 70),
              (1, 8, 4, 100, 100, 256, True, 0),
              # whisper-tiny's hd 64: the encoder's non-causal T 1,500 (off
              # every tile), the cross-attention's 2,048 prompt rows over
              # 1,500 frames, and a ragged small one
              (8, 6, 6, 1500, 1500, 64, False, 0),
              (8, 6, 6, 2048, 1500, 64, False, 0),
              (2, 6, 6, 100, 37, 64, False, 0),
              # the wgmma route's edges (bf16 at hd 64, 80 and 128: 128-row
              # blocks, 128-key tiles): T 127 and 128, a window across a
              # key tile with and without causal, and the shifted frame
              # (q_offset, kv_start) at hd 128 and 80
              (1, 6, 6, 127, 127, 64, True, 0),
              (1, 6, 6, 128, 128, 128, True, 0),
              (1, 4, 2, 300, 300, 128, True, 100),
              (1, 4, 2, 190, 190, 128, False, 70),
              (1, 4, 2, 200, 330, 128, True, 0, 64, 40),
              (1, 4, 4, 150, 250, 80, True, 0, 100, 30)]
# the backward kernel against autograd through the plain version, before
# the main paths (which give it qwen2's and whisper's training shapes, held
# again after them): causal GQA 12:2 at hd 128 (qwen2's heads), windowed
# GQA, non-causal ragged hd 64 with Tq != Tk both ways (whisper's heads),
# and the other head dims' tiles; at the forward's tolerances, fp32 5e-4
# and bf16 3e-2 (atol = rtol: the two round to bf16 at different places,
# the plain version its P and the gradients between its ops, the
# tensor-core kernel P and dS as product operands).  Then the wgmma
# route's tile edges at hd 64 and 128 (hd 80, padded to two panels, is on
# that route too): T 127, 128 and 129 about its
# 128-row blocks and 64-row tiles, whisper's encoder T 1,500 and its
# cross-attention's 448 x 1,500, Tq != Tk at hd 128, causal H / Hk = 6 at
# hd 64; and hd 256 on that route (its own kernels: 64-row blocks): T 130
# above, and gemma3-4b's 8:4 at its training length on a local (window
# 1,024) and a global layer, one sequence.
FLASH_BWD_GRID = [(1, 12, 2, 512, 512, 128, True, 0),
                  (2, 12, 2, 1024, 1024, 128, True, 256),
                  (2, 6, 6, 150, 200, 64, False, 0),
                  (2, 6, 6, 300, 130, 64, False, 0),
                  (1, 4, 2, 130, 130, 256, True, 0),
                  (1, 4, 4, 100, 100, 80, True, 0),
                  (1, 2, 1, 190, 190, 32, False, 70),
                  (2, 4, 2, 77, 99, 16, True, 0),
                  (1, 6, 6, 127, 127, 64, True, 0),
                  (1, 6, 6, 128, 128, 128, True, 0),
                  (1, 12, 2, 129, 129, 128, True, 0),
                  (1, 6, 6, 1500, 1500, 64, False, 0),
                  (1, 6, 6, 448, 1500, 64, False, 0),
                  (1, 6, 2, 200, 330, 128, False, 0),
                  (1, 12, 2, 129, 129, 64, True, 0),
                  (1, 8, 4, 2048, 2048, 256, True, 1024),
                  (1, 8, 4, 2048, 2048, 256, True, 0)]
# the wgmma route (bf16 at hd 64, 80, 128 and 256) against its arithmetic
# step by step (``ref.flash_attention_bwd_tiled_ref`` on the kernel's own
# forward output and lse): atol = rtol = 1e-2, about two bf16 steps (both
# round P and dS where they become operands and the gradients at the end;
# an fp32 sum taken in another order, or exp2 against exp, can move a
# rounding by one step)
FLASH_BWD_TILED_TOL = 1e-2
# the mask's shifted frame (a case's optional 9th and 10th entries,
# q_offset and kv_start): qwen2-1.5b's training shape as 16 "model" ranks
# split its sequence (each rank's 128 queries at its offset over the 2,048
# gathered keys), and gemma3-4b's halo frame on one rank (a local layer's
# 2,048 queries at q_offset 1,024 over the 1,024-key halo and its own
# keys, the halo hidden by kv_start as on rank 0)
FLASH_SPLIT = [(8, 12, 2, 128, 2048, 128, True, 0, 128 * r, 0)
               for r in range(16)]
FLASH_HALO = (8, 8, 4, 2048, 3072, 256, True, 1024, 1024, 1024)


def mask_of(case) -> dict:
    """A case's mask settings: (.., causal, window[, q_offset,
    kv_start])."""
    causal, window, *rest = case[6:]
    q_offset, kv_start = rest or (0, 0)
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_start=kv_start)


def flash_inputs(torch, np, case, dtype, seed=3):
    B, H, Hk, Tq, Tk, hd = case[:6]
    g = card_generator(torch, seed)
    return [normal(torch, s, g).to(dtype)
            for s in ((B, H, Tq, hd), (B, Hk, Tk, hd), (B, Hk, Tk, hd))]


# the JAX package's attention tolerances (atol = rtol) by dtype
FLASH_TOLS = (("float32", 5e-4), ("bfloat16", 3e-2))
# the forward's log-sum-exp against ``ref.flash_attention_lse_ref`` (atol:
# the same bf16 qs and k, fp32 sums taken in another order)
FLASH_LSE_TOL = 1e-3


def check_flash(torch, np, fa, ref, cases, dtypes=("float32", "bfloat16")):
    """Kernel vs plain at each case, fp32 (atol = rtol = 5e-4) and bf16
    (3e-2), the JAX package's tolerances; on the wgmma route (bf16 at
    ``fa.WGMMA_HEAD_DIMS``) also the log-sum-exp against the plain one at
    atol ``FLASH_LSE_TOL``, the output with the log-sum-exp bit-equal to
    the one without, and a second call bit-equal to the first.  Returns
    the max abs error in bf16, the serving dtype."""
    worst = 0.0
    for case in cases:
        mask = mask_of(case)
        for dtype, tol in ((getattr(torch, d), t) for d, t in FLASH_TOLS
                           if d in dtypes):
            q, k, v = flash_inputs(torch, np, case, dtype)
            got = fa.flash_attention(q, k, v, **mask)
            want = ref.flash_attention_ref(q, k, v, **mask)
            torch.cuda.synchronize()
            g, r = got.float(), want.float()
            err = float((g - r).abs().max())
            if got.dtype != dtype or got.shape != want.shape or \
                    not bool(((g - r).abs() <= tol + tol * r.abs()).all()):
                fail(f"flash_attention at {case} {dtype}: err {err} beyond "
                     f"atol = rtol = {tol}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            note = ""
            if dtype == torch.bfloat16 and case[5] in fa.WGMMA_HEAD_DIMS:
                again, lse = fa.flash_attention(q, k, v, return_lse=True,
                                                **mask)
                plain = ref.flash_attention_lse_ref(q, k, **mask)
                lerr = float((lse - plain).abs().max())
                if not torch.equal(again, got) or not torch.equal(
                        fa.flash_attention(q, k, v, **mask), got):
                    fail(f"flash_attention at {case} {dtype}: two calls on "
                         f"the same inputs differ")
                if lse.shape != plain.shape or not lerr <= FLASH_LSE_TOL:
                    fail(f"flash_attention lse at {case} {dtype}: err "
                         f"{lerr} beyond atol {FLASH_LSE_TOL}")
                note = f", lse max abs err {lerr:.3g}, two calls bit-equal"
                del again, lse, plain
            print(f"flash_attention {case} {str(dtype)[6:]}: max abs err "
                  f"{err:.3g}{note} ok", flush=True)
            del q, k, v, got, want, g, r
    return worst


def check_flash_bwd(torch, np, mods, ref, cases,
                    dtypes=("float32", "bfloat16")):
    """``ops.attention`` with grad at each case, fp32 and bf16 (the
    forward kernel with its log-sum-exp, then the backward kernel), against
    ``torch.autograd.grad`` through the plain version on the same inputs
    and output gradient, at atol = rtol = 5e-4 (fp32) and 3e-2 (bf16); on
    the wgmma route also against ``ref.flash_attention_bwd_tiled_ref`` at
    ``FLASH_BWD_TILED_TOL``; and two more backward calls on the same
    inputs, which must be bit-equal.  Returns the max abs error of dQ, dK
    and dV against the plain version in bf16, the training dtype.  Its
    launches are outside every main path's counts."""
    from repro_torch.kernels import ops
    fa, fab = mods["flash_attention"], mods["flash_attention_bwd"]
    worst = 0.0
    for case in cases:
        mask, hd = mask_of(case), case[5]
        for dtype, tol in ((getattr(torch, d), t) for d, t in FLASH_TOLS
                           if d in dtypes):
            q, k, v = flash_inputs(torch, np, case, dtype)
            dout = flash_inputs(torch, np, case, dtype, seed=5)[0]
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = (fa.launches, fab.launches)
            out = ops.attention(*(t.transpose(1, 2) for t in ins), **mask)
            got = torch.autograd.grad(out.transpose(1, 2), ins, dout)
            if (fa.launches, fab.launches) != (before[0] + 1,
                                                before[1] + 1):
                fail(f"flash_attention_bwd at {case}: launches "
                     f"{(fa.launches, fab.launches)} after {before}")
            hidden = mask["kv_start"]
            if got[1][:, :, :hidden].any() or got[2][:, :, :hidden].any():
                fail(f"flash_attention_bwd at {case}: keys below kv_start "
                     f"got a gradient")
            plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.flash_attention_ref(*plain, **mask), plain, dout)
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
            again = [fab.flash_attention_bwd(q, k, v, o, dout, lse, **mask)
                     for _ in range(2)]
            wgmma = dtype == torch.bfloat16 and hd in fab.WGMMA_HEAD_DIMS
            tiled = ref.flash_attention_bwd_tiled_ref(
                q, k, v, o, dout, lse, **mask) if wgmma else None
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*again)):
                fail(f"flash_attention_bwd at {case} {dtype}: two calls on "
                     f"the same inputs differ")
            errs, terrs = [], []
            for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got,
                                                 want)):
                g, w = g.float(), w.float()
                errs.append(float((g - w).abs().max()))
                if g.shape != w.shape or not bool(
                        ((g - w).abs() <= tol + tol * w.abs()).all()):
                    fail(f"flash_attention_bwd {name} at {case} {dtype}: "
                         f"err {errs[-1]} beyond atol = rtol = {tol}")
                if tiled is None:
                    continue
                a, t = again[0][i].float(), tiled[i].float()
                terrs.append(float((a - t).abs().max()))
                if not bool(((a - t).abs() <= FLASH_BWD_TILED_TOL
                             + FLASH_BWD_TILED_TOL * t.abs()).all()):
                    fail(f"flash_attention_bwd {name} at {case} {dtype}: "
                         f"err {terrs[-1]} against the tiled version beyond "
                         f"atol = rtol = {FLASH_BWD_TILED_TOL}")
            if dtype == torch.bfloat16:
                worst = max(worst, *errs)
            print(f"flash_attention_bwd {case} {str(dtype)[6:]}: max abs "
                  f"err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}"
                  + (f", against the tiled version {terrs[0]:.3g} "
                     f"{terrs[1]:.3g} {terrs[2]:.3g}" if terrs else "")
                  + ", two calls bit-equal ok", flush=True)
            del q, k, v, dout, ins, out, got, plain, want, o, lse, again
            del tiled
    return worst


def check_flash_offsets(torch, np, mods, ref):
    """The kernel pair in the mask's shifted frame: each of
    ``FLASH_SPLIT``'s 16 rank blocks (bf16; fp32 at the first, a middle
    and the last) and ``FLASH_HALO`` (fp32 and bf16) through
    :func:`check_flash` and :func:`check_flash_bwd`; then the 16 blocks
    at their offsets on one bf16 sequence put back together against the
    whole sequence's kernel pair: the forward's output and dQ concatenated,
    at the bf16 tolerance (3e-2; bit-equality is printed), and dK and dV
    summed over the blocks in fp32, their error printed.  Returns the max
    abs errors (forward, backward) in bf16."""
    fa, fab = mods["flash_attention"], mods["flash_attention_bwd"]
    ends = [FLASH_SPLIT[i] for i in (0, 7, 15)]
    worst = (max(check_flash(torch, np, fa, ref, FLASH_SPLIT, ("bfloat16",)),
                 check_flash(torch, np, fa, ref, ends, ("float32",)),
                 check_flash(torch, np, fa, ref, [FLASH_HALO])),
             max(check_flash_bwd(torch, np, mods, ref, FLASH_SPLIT,
                                 ("bfloat16",)),
                 check_flash_bwd(torch, np, mods, ref, ends, ("float32",)),
                 check_flash_bwd(torch, np, mods, ref, [FLASH_HALO])))
    B, H, Hk, n, Tk, hd = FLASH_SPLIT[0][:6]
    whole = (B, H, Hk, Tk, Tk, hd, True, 0)
    q, k, v = flash_inputs(torch, np, whole, torch.bfloat16)
    dout = flash_inputs(torch, np, whole, torch.bfloat16, seed=5)[0]
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    grads = fab.flash_attention_bwd(q, k, v, out, dout, lse)
    outs, dqs, dk, dv = [], [], 0.0, 0.0
    for case in FLASH_SPLIT:
        r = slice(case[8], case[8] + n)
        o, l = fa.flash_attention(q[:, :, r], k, v, q_offset=case[8],
                                  return_lse=True)
        g = fab.flash_attention_bwd(q[:, :, r], k, v, o, dout[:, :, r], l,
                                    q_offset=case[8])
        outs.append(o)
        dqs.append(g[0])
        dk, dv = dk + g[1].float(), dv + g[2].float()
    torch.cuda.synchronize()
    tol = dict(FLASH_TOLS)["bfloat16"]
    errs = {}
    for name, a, b in (("forward", torch.cat(outs, dim=2), out),
                       ("dq", torch.cat(dqs, dim=2), grads[0]),
                       ("dk", dk, grads[1]), ("dv", dv, grads[2])):
        a, b = a.float(), b.float()
        errs[name] = (float((a - b).abs().max()), bool(torch.equal(a, b)),
                      bool(((a - b).abs() <= tol + tol * b.abs()).all()))
    print(f"flash_attention split {FLASH_SPLIT[0][:3]} x 16 blocks of {n} "
          f"over {Tk} keys against the whole sequence: " + ", ".join(
              f"{k} max abs err {e:.3g} bit-equal {eq} within {tol} {ok}"
              for k, (e, eq, ok) in errs.items()) + f" ({CARD})", flush=True)
    for name in ("forward", "dq"):
        if not errs[name][2]:
            fail(f"flash_attention split: the blocks' {name} is not the "
                 f"whole sequence's within {tol}")
    del q, k, v, dout, out, lse, grads, outs, dqs, dk, dv
    return worst


# a "model" rank's head block of the Mamba2 mixer at the production
# mesh's 16 "model" ranks, at the training batch (B 8 x T 2,048, C 128):
# mamba2-1.3b's 64 heads / 16 (N 128) and zamba2-2.7b's 80 / 16 (N 64, a
# group of 5 of the kernels' 8 heads)
SSD_RANK_BLOCKS = [(8, 2048, 4, 64, 128, 128), (8, 2048, 5, 64, 64, 128)]
# the JAX package's grid (tests/test_kernels.py:61-66), zamba2-2.7b's
# serving shape, and the edges of the kernel's split: T off the chunk, one
# chunk (C = T = 100), H off its group of 8 heads; then the rank blocks:
# (B, T, H, hd, N, chunk)
SSD_GRID = [(2, 128, 4, 16, 32, 64), (1, 96, 2, 8, 16, 32),
            (2, 64, 8, 32, 64, 64), (1, 256, 4, 64, 128, 128),
            (8, 2048, 80, 64, 64, 128), (2, 300, 4, 32, 64, 128),
            (2, 100, 5, 16, 32, 128), (1, 256, 12, 64, 64, 64)] \
    + SSD_RANK_BLOCKS


def ssd_inputs(torch, np, case, dtype, seed=4):
    B, T, H, hd, N = case[:5]
    g = card_generator(torch, seed)
    return (normal(torch, (B, T, H, hd), g).to(dtype),
            normal(torch, (B, T, H), g).abs() * 0.5 + 0.01,
            normal(torch, (H,), g).abs() * 0.5 + 0.1,
            normal(torch, (B, T, N), g), normal(torch, (B, T, N), g))


def check_ssd(torch, np, ssd, ref, cases):
    """Kernel vs plain at each case with xh in fp32 and in bf16: the JAX
    package's 2e-3 (atol = rtol), and for bf16 y an rtol of 2e-3 + 2^-7,
    since both round y from fp32 to bf16 and fp32 sums taken in another
    order can round it one bf16 step (2^-7 relative) apart; the state is
    fp32 either way.  Returns the max abs error of y in bf16, the serving
    dtype."""
    worst = 0.0
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(torch, np, case, dtype)
            y, h = ssd.ssd_scan(*ins, chunk=case[5])
            yr, hr = ref.ssd_scan_ref(*ins, chunk=case[5])
            torch.cuda.synchronize()
            rtol = 2e-3 if dtype == torch.float32 else 2e-3 + 2 ** -7
            err = float((y.float() - yr.float()).abs().max())
            herr = float((h - hr).abs().max())
            if y.dtype != dtype or h.dtype != torch.float32 or \
                    not bool(((y.float() - yr.float()).abs()
                              <= 2e-3 + rtol * yr.float().abs()).all()) or \
                    not bool(((h - hr).abs() <= 2e-3 + 2e-3 * hr.abs()).all()):
                fail(f"ssd_scan at {case} {dtype}: y err {err}, state err "
                     f"{herr}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            print(f"ssd_scan {case} {str(dtype)[6:]}: max abs err y {err:.3g}"
                  f" state {herr:.3g} ok", flush=True)
            del ins, y, h, yr, hr
    return worst


def check_ssd_states(torch, np, ssd, ref, case):
    """The state each chunk starts from, which the kernel's inter-chunk
    pass leaves in its scratch, against the plain three-pass split
    (``ref.ssd_scan_passes_ref``) at the state's tolerance, 2e-3."""
    ins = ssd_inputs(torch, np, case, torch.bfloat16)
    _, _, h_in = ssd.ssd_scan_with_states(*ins, chunk=case[5])
    _, _, h_in_r = ref.ssd_scan_passes_ref(*ins, chunk=case[5])
    torch.cuda.synchronize()
    err = float((h_in - h_in_r).abs().max())
    if h_in.shape != h_in_r.shape or \
            not bool(((h_in - h_in_r).abs() <= 2e-3 + 2e-3 * h_in_r.abs())
                     .all()):
        fail(f"ssd_scan chunk states at {case}: err {err}")
    print(f"ssd_scan chunk states {case} {tuple(h_in.shape)}: max abs err "
          f"{err:.3g} ok", flush=True)


# the backward kernel: the forward's grid but its largest case (ragged T,
# one chunk, N 16 to 128, H off the group of 8 heads, the rank blocks) and
# N 8 at a ragged
# T over chunks of 16; the edges of the bf16 wgmma route (hd 64, C 128, N
# 64 and 128 in 64-column blocks): T off the chunk and H off the head
# group at N 128, fewer heads than a group at N 64; then, after the
# training paths, at every shape they gave it (mamba2-1.3b's and
# zamba2-2.7b's, B 8 x T 2,048 at C 128: N 128 over 64 heads, N 64 over
# 80)
SSD_BWD_GRID = [c for c in SSD_GRID if c[0] * c[1] * c[2] < 2 ** 17] + [
    (2, 50, 3, 16, 8, 16), (2, 300, 12, 64, 128, 128),
    (1, 330, 5, 64, 64, 128)]
# against the split plain version (``ref.ssd_scan_bwd_passes_ref``) on the
# kernel's own per-chunk states: atol 1e-4 x each gradient's largest
# magnitude + rtol 1e-4 (both fp32; the kernel's fp32 operands are bf16 hi
# + lo, about 2^-16 relative a product), bf16 dxh at rtol 2^-7 (one bf16
# step: both round it once); against autograd through ``ref.ssd_scan_ref``
# at the forward's bf16 tolerance scaled by each gradient's largest
# magnitude, atol 2e-3 x max + rtol 2e-3 + 2^-7 (the plain scan rounds W,
# the end decays and B to xh's dtype inside its products; dA and dB sum
# 2^14-2^17 terms at the training shapes)
SSD_BWD_SPLIT_TOL = 1e-4
SSD_BWD_PLAIN_TOL = 2e-3


def ssd_bwd_inputs(torch, np, case, dtype, seed=6):
    """The forward's inputs (``ssd_inputs``), and dy in xh's dtype and an
    fp32 final-state gradient."""
    B, T, H, hd, N = case[:5]
    ins = ssd_inputs(torch, np, case, dtype, seed=seed)
    g = card_generator(torch, seed + 1)
    return ins, normal(torch, (B, T, H, hd), g).to(dtype), \
        normal(torch, (B, H, hd, N), g)


def _ssd_bwd_err(got, want, atol_of_max, rtols):
    """The largest |got - want| of each gradient, and whether each is
    within atol_of_max x max|want| + rtol |want|."""
    errs, ok = [], True
    for g, w, rtol in zip(got, want, rtols):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        errs.append(float(d.max()))
        ok &= g.shape == w.shape and bool(
            (d <= atol_of_max * w.abs().max() + rtol * w.abs()).all())
    return errs, ok


def check_ssd_bwd(torch, np, ssd, ssdb, ref, cases):
    """The backward kernel on the forward kernel's per-chunk states, at
    each case, xh in fp32 and bf16, with a final-state gradient and
    without (None, as training gives it): against the split plain version
    and against autograd through the plain scan (the tolerances above), and
    two calls bit-equal.  Returns the max abs error against the plain
    version in bf16, the training dtype.  Its launches are outside every
    main path's counts."""
    worst = 0.0
    names = ("dxh", "ddt", "dA", "dBm", "dCm")
    for case in cases:
        C = case[5]
        for dtype in (torch.float32, torch.bfloat16):
            for final in (True, False):
                ins, dy, dh = ssd_bwd_inputs(torch, np, case, dtype)
                dh = dh if final else None
                _, _, states = ssd.ssd_scan_with_states(*ins, chunk=C)
                got = ssdb.ssd_scan_bwd(*ins, states, dy, dh, chunk=C)
                again = ssdb.ssd_scan_bwd(*ins, states, dy, dh, chunk=C)
                split = ref.ssd_scan_bwd_passes_ref(*ins, states, dy, dh,
                                                    chunk=C)
                rt = SSD_BWD_SPLIT_TOL
                serr, sok = _ssd_bwd_err(
                    got, split, rt,
                    (rt if dtype == torch.float32 else 2 ** -7,) + (rt,) * 4)
                del split
                plain_in = [t.clone().requires_grad_(True) for t in ins]
                y, h = ref.ssd_scan_ref(*plain_in, chunk=C)
                loss = (y.float() * dy.float()).sum()
                if dh is not None:
                    loss = loss + (h * dh).sum()
                plain = torch.autograd.grad(loss, plain_in)
                del y, h, loss
                pt = SSD_BWD_PLAIN_TOL
                perr, pok = _ssd_bwd_err(got, plain, pt, (pt + 2 ** -7,) * 5)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                label = (f"ssd_scan_bwd {case} {str(dtype)[6:]} "
                         f"{'dh_final' if final else 'no dh_final'}")
                if not (sok and pok and same) or got[0].dtype != dtype:
                    fail(f"{label}: against the split version "
                         f"{dict(zip(names, serr))}, against the plain "
                         f"{dict(zip(names, perr))}, two calls bit-equal "
                         f"{same}")
                if dtype == torch.bfloat16:
                    worst = max(worst, *perr)
                print(f"{label}: max abs err against the split version "
                      + " ".join(f"{n} {e:.3g}" for n, e in zip(names, serr))
                      + ", against the plain " + " ".join(
                          f"{n} {e:.3g}" for n, e in zip(names, perr))
                      + ", two calls bit-equal ok", flush=True)
                del ins, dy, dh, states, got, again, plain_in, plain
        torch.cuda.empty_cache()
    return worst


# mamba2-1.3b's and zamba2-2.7b's training shapes (B 8 x T 2,048, C 128),
# cut into (blocks) chunk-aligned blocks as 4 and 16 "model" ranks split
# the sequence under fsdp_tp_seq: ((B, T, H, hd, N, C), blocks)
SSD_SPLIT = [(case, blocks) for case in ((8, 2048, 64, 64, 128, 128),
                                         (8, 2048, 80, 64, 64, 128))
             for blocks in (4, 16)]
# a 16-way rank block of mamba2-1.3b's, timed with h0 and dh0
SSD_SPLIT_BLOCK = (8, 128, 64, 64, 128, 128)


def check_ssd_offsets(torch, np, ssd, ssdb, ref):
    """The SSD kernel pair with an incoming state: each ``SSD_SPLIT`` case
    (fp32 and bf16 xh) cut into chunk-aligned blocks, the forward chained
    from block to block through ``h0`` (each block from the last one's
    final state) and the backward chained back through ``dh0`` (each
    block's incoming-state gradient the last one's ``dh_final``), against
    the whole sequence's kernel pair: the forward's output and final state
    bit-equal (the walk is the same arithmetic), the gradients at
    ``check_ssd_bwd``'s split tolerance (dA's chunk shares are summed in
    another order), and each block's ``dh0`` against autograd through the
    plain scan started from the same ``h0`` at its plain tolerance.
    Returns the max abs errors (forward, backward) in bf16."""
    worst = [0.0, 0.0]
    names = ("dxh", "ddt", "dA", "dBm", "dCm")
    for case, blocks in SSD_SPLIT:
        B, T, H, hd, N, C = case
        n = T // blocks
        for dtype in (torch.float32, torch.bfloat16):
            ins, dy, dh = ssd_bwd_inputs(torch, np, case, dtype)
            y, hfin, states = ssd.ssd_scan_with_states(*ins, chunk=C)
            whole = ssdb.ssd_scan_bwd(*ins, states, dy, dh, chunk=C)
            del states

            def block(t, r):
                return t if t.ndim == 1 else \
                    t[:, r * n:(r + 1) * n].contiguous()
            h, hs, ys, st = None, [], [], []
            for r in range(blocks):
                hs.append(h)
                yr, h, sr = ssd.ssd_scan_with_states(
                    *(block(t, r) for t in ins), chunk=C, h0=h)
                ys.append(yr)
                st.append(sr)
            g, parts, dh0s = dh, [None] * blocks, [None] * blocks
            for r in reversed(range(blocks)):
                got = ssdb.ssd_scan_bwd(*(block(t, r) for t in ins), st[r],
                                        block(dy, r), g, chunk=C,
                                        with_dh0=True)
                parts[r], g = got[:5], got[5]
                dh0s[r] = g
            del st
            chain = (torch.cat([p[0] for p in parts], 1),
                     torch.cat([p[1] for p in parts], 1),
                     sum(p[2] for p in parts),
                     torch.cat([p[3] for p in parts], 1),
                     torch.cat([p[4] for p in parts], 1))
            yc = torch.cat(ys, 1)
            torch.cuda.synchronize()
            y_eq, h_eq = bool(torch.equal(yc, y)), bool(torch.equal(h, hfin))
            ferr = float((yc.float() - y.float()).abs().max())
            rt = SSD_BWD_SPLIT_TOL
            berr, bok = _ssd_bwd_err(
                chain, whole, rt,
                (rt if dtype == torch.float32 else 2 ** -7,) + (rt,) * 4)
            bit = [bool(torch.equal(a, b)) for a, b in zip(chain, whole)]
            # each block's dh0 against autograd through the plain scan
            # from the same incoming state
            pt = SSD_BWD_PLAIN_TOL
            derr, dok = 0.0, True
            for r in range(blocks):
                h0 = hs[r] if hs[r] is not None else torch.zeros_like(hfin)
                plain_in = [block(t, r).clone().requires_grad_(True)
                            for t in ins] + [h0.clone().requires_grad_(True)]
                yp, hp = ref.ssd_scan_ref(*plain_in[:5], chunk=C,
                                          h0=plain_in[5])
                loss = (yp.float() * block(dy, r).float()).sum()
                g_out = dh0s[r + 1] if r + 1 < blocks else dh
                loss = loss + (hp * g_out).sum()
                want = torch.autograd.grad(loss, plain_in[5])[0]
                e, ok = _ssd_bwd_err((dh0s[r],), (want,), pt,
                                     (pt + 2 ** -7,))
                derr, dok = max(derr, e[0]), dok and ok
                del plain_in, yp, hp, loss, want
            label = (f"ssd_scan pair {case} {str(dtype)[6:]} as {blocks} "
                     f"blocks of {n} chained through h0 / dh0")
            print(f"{label}: forward max abs err {ferr:.3g} y bit-equal "
                  f"{y_eq} final state bit-equal {h_eq}; backward against "
                  f"the whole sequence " + " ".join(
                      f"{k} {e:.3g}{' (bit-equal)' if b else ''}"
                      for k, e, b in zip(names, berr, bit))
                  + f"; dh0 against autograd {derr:.3g} ({CARD})",
                  flush=True)
            if not (y_eq and h_eq):
                print(f"{label}: the chained forward is not the whole "
                      f"sequence's bits", flush=True)
                ok = bool(((yc.float() - y.float()).abs()
                           <= 2e-3 + 2e-3 * y.float().abs()).all())
                if not ok:
                    fail(f"{label}: forward err {ferr}")
            if not (bok and dok) or chain[0].dtype != dtype:
                fail(f"{label}: backward against the whole sequence "
                     f"{dict(zip(names, berr))}, dh0 against autograd "
                     f"{derr}")
            if dtype == torch.bfloat16:
                worst = [max(worst[0], ferr), max(worst[1], *berr, derr)]
            del ins, dy, dh, y, hfin, whole, hs, ys, parts, dh0s, chain, yc
            del h, g
            torch.cuda.empty_cache()
    return tuple(worst)


def record_shapes(mod, name: str, seen, key):
    """Wrap the kernel wrapper ``mod.<name>`` (which ``kernels.ops`` looks
    up at each call) so every call adds ``key(*args, **kw)`` to ``seen`` (a
    set of shapes, or a list that keeps one entry a call); returns a
    function that restores it."""
    fn = getattr(mod, name)
    keep = seen.append if isinstance(seen, list) else seen.add

    def wrapped(*args, **kw):
        keep(key(*args, **kw))
        return fn(*args, **kw)
    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, fn)


def margin_key(h, w):
    return (h.shape[0], h.shape[1], w.shape[1])


def pairwise_key(x, c):
    return (x.shape[0], c.shape[0], x.shape[1])


def flash_key(q, k, v, *, causal=True, window=0, scale=None,
              return_lse=False, q_offset=0, kv_start=0):
    """(B, H, Hk, Tq, Tk, hd, causal, window), and q_offset and kv_start
    where either is set."""
    B, H, Tq, hd = q.shape
    key = (B, H, k.shape[1], Tq, k.shape[2], hd, bool(causal), int(window))
    if q_offset or kv_start:
        key += (int(q_offset), int(kv_start))
    return key


def flash_bwd_key(q, k, v, out, dout, lse, *, causal=True, window=0,
                  scale=None, q_offset=0, kv_start=0):
    return flash_key(q, k, v, causal=causal, window=window,
                     q_offset=q_offset, kv_start=kv_start)


def ssd_key(xh, dt, A, Bm, Cm, *, chunk=128, h0=None):
    B, T, H, hd = xh.shape
    return (B, T, H, hd, Bm.shape[-1], chunk)


def ssd_bwd_key(xh, dt, A, Bm, Cm, h_in, dy, dh_final=None, *, chunk=128,
                with_dh0=False):
    return ssd_key(xh, dt, A, Bm, Cm, chunk=chunk)


PHASES = ("train", "score", "eval_correct", "topk_candidates",
          "kcenter_candidates", "anchor_features", "machine_label_sweep")
# the margin campaign's decisions as the earlier runs of this script on the
# card recorded them, before the sweep runtime and the graph retrain
RECORDED_MARGIN = {"decision": "hybrid", "B": 2000, "S": 43225, "cost": "271.50",
               "error": "0.04146", "iterations": 4}


def time_phases(torch, task, sizes=None):
    """Wrap the task's passes so each call's wall time, up to a device
    synchronize, adds to its phase: the campaign's breakdown.  ``sizes``
    collects each retrain's row count."""
    spent = dict.fromkeys(PHASES, 0.0)
    for name in PHASES:
        if not hasattr(task, name):
            continue

        def timed(*args, _fn=getattr(task, name), _name=name, **kw):
            if _name == "train" and sizes is not None:
                sizes.append(len(args[0]))
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            spent[_name] += time.perf_counter() - t0
            return out
        setattr(task, name, timed)
    return spent


def summary(res) -> dict:
    return {"decision": res.decision, "B": res.B_size, "S": res.S_size,
            "cost": f"{res.total_cost:.2f}",
            "error": f"{res.measured_error:.5f}",
            "iterations": len(res.history)}


def run_campaigns(torch, np, mh, pd, pool: int, max_iters: int, seen: dict,
                  trace_dir: Path):
    """Both campaigns on the default route (the paged sweep runtime, the
    retrain as a replayed CUDA graph), each followed by its sibling on the
    eager retrain loop (the earlier route for the retrain), which must end the
    same way.  ``seen`` collects the shapes each kernel was given; returns
    the launch counts, the retrain sizes, the trained margin task and the
    default-route margin campaign's trace and result."""
    from repro_torch.core import AMAZON, LiveTask, MCALConfig, run_mcal
    from repro_torch.data.synth import make_classification
    from repro_torch.trace import TraceStore

    x, y = make_classification(pool, num_classes=10, dim=32,
                               difficulty=0.3, seed=0)
    eps = 0.05
    launches = {"margin_head": 0, "pairwise_sqdist": 0}
    sizes: list = []
    restore = [record_shapes(mh, "margin_head", seen["margin_head"],
                             margin_key),
               record_shapes(pd, "pairwise_sqdist", seen["pairwise_sqdist"],
                             pairwise_key)]
    out = {}
    for metric in ("margin", "kcenter"):
        ends = {}
        for route in ("graph", "eager"):
            task = LiveTask(features=x, groundtruth=y, num_classes=10)
            if route == "eager":
                task._fit.fit = task._fit.fit_eager
            spent = time_phases(torch, task,
                                sizes if route == "graph" else None)
            cfg = MCALConfig(eps_target=eps, seed=0, metric=metric,
                             max_iters=max_iters)
            trace = None
            if metric == "margin" and route == "graph":
                trace = TraceStore(str(trace_dir / "sync.jsonl"), "live-s0")
            torch.cuda.synchronize()
            mh.launches = 0
            pd.launches = 0
            t0 = time.perf_counter()
            res = run_mcal(task, AMAZON, cfg, trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {"margin_head": mh.launches, "pairwise_sqdist": pd.launches}
            if trace is not None:
                trace.close()
                out["sync"] = (trace_dir / "sync.jsonl", res)
            task.close()
            for k, v in got.items():
                launches[k] += v
            ends[route] = summary(res)
            print(f"campaign metric={metric} route={route} pool={pool} "
                  f"max_iters={max_iters}: decision {res.decision}, |B| "
                  f"{res.B_size}, |S| {res.S_size}, cost "
                  f"{res.total_cost:.2f}, measured error "
                  f"{res.measured_error:.5f}, iterations "
                  f"{len(res.history)}, wall {wall:.2f} s, launches {got}",
                  flush=True)
            print(f"campaign metric={metric} route={route} seconds by phase: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in spent.items() if v)
                  + f", rest {wall - sum(spent.values()):.3f}", flush=True)
            if res.labels.shape != (pool,) or (res.labels < 0).any():
                fail(f"{metric} campaign left rows unlabeled")
            if not res.measured_error <= eps + 0.01:
                fail(f"{metric} campaign error {res.measured_error} > "
                     f"{eps + 0.01}")
            if got["margin_head"] == 0:
                fail(f"margin_head never launched in the {metric} campaign")
            if metric == "kcenter" and got["pairwise_sqdist"] == 0:
                fail("pairwise_sqdist never launched in the k-center "
                     "campaign")
            if metric == "margin" and route == "graph":
                out["task"] = task
        if ends["graph"] != ends["eager"]:
            fail(f"{metric} campaign: the graph retrain ended {ends['graph']}"
                 f", the eager loop {ends['eager']}")
        out[f"{metric}_end"] = ends["graph"]
        if metric == "margin" and pool == 50_000:
            print(f"campaign metric=margin against the recorded decisions "
                  f"{RECORDED_MARGIN}: "
                  f"{'same' if ends['graph'] == RECORDED_MARGIN else 'moved'}",
                  flush=True)
    for r in restore:
        r()
    out.update(launches=launches, sizes=sizes, data=(x, y))
    return out


def launcher_campaign(torch, mh, x, y, trace_dir: Path, max_iters: int,
                      mesh=None, tag: str = "async"):
    """The margin campaign through ``repro_torch.launch.label.run_campaign``
    with ``sweep_async``, ``fit_async``, ``fit_resident`` and a trace,
    preempted every two iterations and resumed from its state file, over
    ``mesh`` where given.  Returns its result, runs, wall seconds, seconds
    by phase (summed over the runs), margin_head's launches and the trace's
    path."""
    from repro_torch.core import AMAZON, LiveTask, MCALConfig
    from repro_torch.launch.label import run_campaign

    state, path = trace_dir / f"state-{tag}.json", trace_dir / f"{tag}.jsonl"
    cfg = MCALConfig(eps_target=0.05, seed=0, metric="margin",
                     max_iters=max_iters, sweep_async=True, fit_async=True)
    spent = dict.fromkeys(PHASES, 0.0)
    torch.cuda.synchronize()
    mh.launches = 0
    t0 = time.perf_counter()
    res, hops = None, 0
    while res is None:
        task = LiveTask(features=x, groundtruth=y, num_classes=10,
                        fit_resident=True, mesh=mesh)
        hop = time_phases(torch, task)
        res, camp = run_campaign(task, AMAZON, cfg, state_path=str(state),
                                 iters_per_run=2, trace_path=str(path),
                                 campaign_id="live-mlp-s0")
        for k, v in hop.items():
            spent[k] += v
        hops += 1
        if hops > 20:
            fail(f"the {tag} launcher campaign never finished")
    torch.cuda.synchronize()
    return (res, hops, time.perf_counter() - t0, spent, mh.launches, path)


def run_launcher_campaign(torch, mh, x, y, sync, trace_dir: Path,
                          max_iters: int):
    """``launcher_campaign`` on this process's device: its trace must diff
    clean against the synchronous campaign's and its result equal it.
    Returns margin_head's launches over all its runs, its result and its
    seconds by phase."""
    from repro_torch.trace import diff

    sync_path, sync_res = sync
    res, hops, wall, spent, launches, path = launcher_campaign(
        torch, mh, x, y, trace_dir, max_iters)
    d = diff(str(sync_path), str(path))
    print(f"launcher campaign (sweep_async, fit_async, fit_resident, "
          f"iters_per_run 2): {hops} runs, {summary(res)}, wall {wall:.2f} s "
          f"over all runs, margin_head launches {launches}, trace diff "
          f"against the synchronous campaign: "
          f"{'clean' if d is None else d.describe()}", flush=True)
    if hops < 2:
        fail("the launcher campaign was never preempted")
    if d is not None:
        fail(f"launcher campaign trace: {d.describe()}")
    if summary(res) != summary(sync_res) or \
            not (res.labels == sync_res.labels).all():
        fail(f"launcher campaign ended {summary(res)}, the synchronous one "
             f"{summary(sync_res)}")
    if launches == 0:
        fail("margin_head never launched in the launcher campaign")
    return launches, res, dict(spent, wall=wall)


def mesh_campaign_child(pool: int, max_iters: int, trace_dir: str) -> None:
    """The child process of the mesh phase's campaign: the data
    ``run_campaigns`` makes, ``launcher_campaign`` unmeshed (which also
    warms this process: its CUDA context, kernels, cuBLAS) and then over a
    one-rank NCCL group (``--mesh data=1``); prints one JSON line."""
    import zlib

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synth import make_classification
    from repro_torch.kernels import margin_head as mh
    from repro_torch.launch.label import build_mesh
    from repro_torch.launch.mesh import CAMPAIGN_THREADS, thread_groups
    x, y = make_classification(pool, num_classes=10, dim=32,
                               difficulty=0.3, seed=0)
    plain = launcher_campaign(torch, mh, x, y, Path(trace_dir), max_iters,
                              tag="child")
    t0 = time.perf_counter()
    mesh = build_mesh("data=1", "cuda")
    setup = time.perf_counter() - t0
    # what each scoring engine pays on a mesh before its first pass: its
    # thread groups, and a first collective on each (NCCL makes its
    # communicator there)
    t0 = time.perf_counter()
    groups = thread_groups(mesh, "data", CAMPAIGN_THREADS)
    made = time.perf_counter() - t0
    probe = torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    for g in groups.values():
        torch.distributed.all_reduce(probe, group=g)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    res, hops, wall, spent, launches, path = launcher_campaign(
        torch, mh, x, y, Path(trace_dir), max_iters, mesh=mesh, tag="mesh")
    print(json.dumps({
        "summary": summary(res), "runs": hops, "wall": wall,
        "spent": spent, "launches": launches, "trace": str(path),
        "plain_summary": summary(plain[0]), "plain_wall": plain[2],
        "plain_spent": plain[3],
        "labels_crc": zlib.crc32(res.labels.tobytes()),
        "backend": torch.distributed.get_backend(),
        "world": torch.distributed.get_world_size(),
        "mesh_seconds": setup, "groups_seconds": made,
        "first_collectives_seconds": first}), flush=True)
    torch.distributed.destroy_process_group()


def run_mesh_campaign(torch, trace_dir: Path, pool: int, max_iters: int,
                      sync_path: Path, unmeshed):
    """Mesh phase (a): ``launcher_campaign`` over ``--mesh data=1``, a
    one-rank NCCL group, in a child process (``mesh_campaign_child``): its
    result must equal the unmeshed launcher campaign's (this process's
    and the child's own, run first) and its trace diff clean against the
    synchronous campaign's.  Prints its seconds by phase beside the
    child's unmeshed run's.  Returns the meshed run's margin_head
    launches."""
    import zlib

    from repro_torch.launch.mesh import CAMPAIGN_THREADS
    from repro_torch.trace import diff
    res, spent = unmeshed
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-campaign",
         str(trace_dir), "--pool", str(pool), "--max-iters",
         str(max_iters)], capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"the mesh campaign's child exited {out.returncode}: "
             f"{out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    d = diff(str(sync_path), got["trace"])
    print(f"mesh campaign (--mesh data=1 on a {got['world']}-rank "
          f"{got['backend']} group, child process {secs:.1f} s, group "
          f"set-up {got['mesh_seconds']:.2f} s; an engine's "
          f"{len(CAMPAIGN_THREADS)} thread groups "
          f"{got['groups_seconds']:.2f} s and their first collectives "
          f"{got['first_collectives_seconds']:.2f} s): {got['runs']} runs, "
          f"{got['summary']}, wall {got['wall']:.2f} s against "
          f"{got['plain_wall']:.2f} s unmeshed in the same process "
          f"({spent['wall']:.2f} s in this one), margin_head launches "
          f"{got['launches']}, trace diff against the synchronous "
          f"campaign: {'clean' if d is None else d.describe()} ({CARD})",
          flush=True)
    plain = got["plain_spent"]
    print("mesh campaign seconds by phase, meshed | unmeshed: " + ", ".join(
        f"{k} {got['spent'][k]:.3f} | {plain[k]:.3f}" for k in PHASES
        if got["spent"][k] or plain[k]) + f" ({CARD})", flush=True)
    if got["backend"] != "nccl" or got["world"] != 1:
        fail(f"the mesh campaign ran on {got['backend']} x {got['world']}")
    if got["summary"] != summary(res) or \
            got["plain_summary"] != summary(res) or \
            got["labels_crc"] != zlib.crc32(res.labels.tobytes()):
        fail(f"the mesh campaign ended {got['summary']}, the unmeshed one "
             f"{summary(res)}")
    if d is not None:
        fail(f"mesh campaign trace: {d.describe()}")
    if got["launches"] == 0:
        fail("margin_head never launched in the mesh campaign")
    return got["launches"]


def run_kcenter_plain_distances(torch, x, y, max_iters: int, kernel_end):
    """The k-center campaign again with ``kernels.ops.pairwise_sqdist``
    routed to its plain fp32 version (the margin head still on its kernel):
    both distance routes' iterations, |S| and distance calls are printed.
    Near ties split fp32 routes, so a different trajectory is printed, not
    failed."""
    from repro_torch.core import AMAZON, LiveTask, MCALConfig, run_mcal
    from repro_torch.kernels import ops, ref

    calls = {"plain": 0}
    kernel_fn = ops.pairwise_sqdist

    def plain(a, c):
        calls["plain"] += 1
        return ref.pairwise_sqdist_ref(a, c)
    ops.pairwise_sqdist = plain
    try:
        task = LiveTask(features=x, groundtruth=y, num_classes=10)
        t0 = time.perf_counter()
        res = run_mcal(task, AMAZON, MCALConfig(
            eps_target=0.05, seed=0, metric="kcenter", max_iters=max_iters))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        task.close()
    finally:
        ops.pairwise_sqdist = kernel_fn
    end = summary(res)
    print(f"campaign metric=kcenter distances=plain: {end}, distance calls "
          f"{calls['plain']}, wall {wall:.2f} s; distances=kernel: "
          f"{kernel_end} -> "
          f"{'same' if end == kernel_end else 'different trajectory'}",
          flush=True)
    if res.labels.shape != (len(x),) or (res.labels < 0).any():
        fail("the plain-distance k-center campaign left rows unlabeled")


# the reference's replay campaigns (repro.launch.label --dataset ..., CPU
# JAX, seed 0, eps 0.05, amazon): (dataset, arch, metric) -> decision,
# |B|, |S|, cost, iterations.  The emulator's error depends only on |B|,
# so k-center's picks cannot move these.
REPLAY_CASES = {
    ("cifar10", "resnet18", "margin"): ("hybrid", 11000, 33580, "780.80", 9),
    ("cifar10", "resnet18", "kcenter"): ("hybrid", 11000, 33580, "780.80",
                                         9),
    ("imagenet", "efficientnet-b0", "margin"): ("human_all", 36000, 0,
                                                "53760.00", 3),
}


def run_replay_campaigns(torch, pd, seen: set):
    """The paper-scale replay campaigns through ``make_emulated_task`` on
    the card (k-center's greedy and its anchor distances there; the
    emulator's draws and the paged sweeps on the host).  Each must end as
    the reference's; k-center must launch ``pairwise_sqdist``.  Returns
    the launches of the k-center campaign."""
    from repro_torch.core import AMAZON, MCALConfig, make_emulated_task, \
        run_mcal
    launches = 0
    restore = record_shapes(pd, "pairwise_sqdist", seen, pairwise_key)
    for (dataset, arch, metric), want in REPLAY_CASES.items():
        task = make_emulated_task(dataset, arch, seed=0)
        spent = time_phases(torch, task)
        torch.cuda.synchronize()
        pd.launches = 0
        t0 = time.perf_counter()
        res = run_mcal(task, AMAZON, MCALConfig(eps_target=0.05, seed=0,
                                                metric=metric))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = pd.launches
        got = (res.decision, res.B_size, res.S_size,
               f"{res.total_cost:.2f}", len(res.history))
        print(f"replay {dataset}/{arch} metric={metric} pool "
              f"{task.pool_size}: decision {got[0]}, |B| {got[1]}, |S| "
              f"{got[2]}, cost {got[3]}, measured error "
              f"{res.measured_error:.5f}, iterations {got[4]}, wall "
              f"{wall:.3f} s, pairwise_sqdist launches {n}", flush=True)
        print(f"replay {dataset}/{arch} metric={metric} seconds by phase: "
              + ", ".join(f"{k} {v:.3f}" for k, v in spent.items() if v)
              + f", rest {wall - sum(spent.values()):.3f}", flush=True)
        if got != want:
            fail(f"replay {dataset}/{arch} {metric} ended {got}, the "
                 f"reference {want}")
        if (res.labels < 0).any():
            fail(f"replay {dataset}/{arch} {metric} left rows unlabeled")
        if metric == "kcenter":
            if n == 0:
                fail("pairwise_sqdist never launched in the replay k-center "
                     "campaign")
            launches += n
    restore()
    return launches


def run_noisy_campaign(torch, mh, x, y, trace_dir: Path, max_iters: int,
                       seen: set):
    """The live margin campaign buying every label from a noisy annotation
    service (5 workers, noise 0.2, 3 votes a label, Dawid-Skene on the
    card), through ``launch.label.run_campaign``: once uninterrupted, once
    preempted every two iterations and resumed from its state file.  The
    traces must diff clean, the results be equal, and ``margin_head``
    launch.  Returns its launches over both runs."""
    from repro_torch.annotation import make_annotation_service
    from repro_torch.core import AMAZON, LiveTask, MCALConfig
    from repro_torch.launch.label import run_campaign
    from repro_torch.trace import diff

    def task():
        svc = make_annotation_service(10, n_workers=5, noise=0.2, repeats=3,
                                      aggregator="ds", pricing=AMAZON,
                                      seed=0)
        return LiveTask(features=x, groundtruth=y, num_classes=10,
                        annotation=svc)
    first = task()
    t0 = time.perf_counter()
    quality = first.annotation.calibrate()
    cal_s = time.perf_counter() - t0
    cfg = MCALConfig(eps_target=0.1, seed=0, max_iters=max_iters,
                     label_quality=quality)
    restore = record_shapes(mh, "margin_head", seen, margin_key)
    whole, cut = trace_dir / "noisy.jsonl", trace_dir / "noisy_cut.jsonl"
    state = trace_dir / "noisy_state.json"
    torch.cuda.synchronize()
    mh.launches = 0
    t0 = time.perf_counter()
    res, _ = run_campaign(first, AMAZON, cfg, trace_path=str(whole),
                          campaign_id="live-noisy-s0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    votes = first.annotation.votes_bought
    resumed, hops = None, 0
    while resumed is None:
        resumed, _ = run_campaign(task(), AMAZON, cfg,
                                  state_path=str(state), iters_per_run=2,
                                  trace_path=str(cut),
                                  campaign_id="live-noisy-s0")
        hops += 1
        if hops > 50:
            fail("the noisy campaign never finished")
    torch.cuda.synchronize()
    launches = mh.launches
    restore()
    d = diff(str(whole), str(cut))
    print(f"noisy campaign (5 workers, noise 0.2, 3 votes, ds; calibrated "
          f"residual {quality.residual_error:.5f} in {cal_s:.3f} s): "
          f"{summary(res)}, votes {votes}, ledger human_votes "
          f"{res.ledger['human_votes']}, wall {wall:.2f} s; preempted "
          f"every 2 iterations: {hops} runs, {summary(resumed)}, trace "
          f"diff {'clean' if d is None else d.describe()}, margin_head "
          f"launches {launches}", flush=True)
    if d is not None:
        fail(f"noisy campaign trace: {d.describe()}")
    if hops < 2:
        fail("the noisy campaign was never preempted")
    if summary(res) != summary(resumed) or \
            not (res.labels == resumed.labels).all():
        fail(f"noisy campaign resumed to {summary(resumed)}, not "
             f"{summary(res)}")
    if res.ledger["human_votes"] != votes or votes != \
            3 * res.ledger["human_labels"] or (res.labels < 0).any():
        fail(f"noisy campaign charged {res.ledger['human_votes']} votes, "
             f"the service sold {votes}")
    if launches == 0:
        fail("margin_head never launched in the noisy campaign")
    return launches


def check_aggregator(torch, np, n=50_000, workers=5, classes=100,
                     repeats=3, reps=5):
    """The vote aggregator on the card against the float64 host oracles:
    majority exact (ties to the first class), Dawid-Skene posteriors,
    confusion and prior within the JAX package's atol 1e-4 with identical
    labels; seconds per aggregation (to the host result)."""
    from repro_torch.annotation import (VoteAggregator, dawid_skene_host,
                                        majority_vote_host,
                                        make_annotator_pool,
                                        vote_counts_host)
    pool = make_annotator_pool(workers, classes, noise=0.25,
                               spammer_frac=0.2, seed=0)
    gt = np.random.default_rng(1).integers(0, classes, n)
    votes = pool.vote_matrix(np.arange(n), gt, repeats)
    agg = VoteAggregator(classes)

    def timed(fn):
        out = fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times)
    (lab, conf), maj_s = timed(lambda: agg.majority(votes))
    lh, ch = majority_vote_host(votes, classes)
    top2 = np.sort(vote_counts_host(votes, classes), axis=1)[:, -2:]
    ties = int(np.sum(top2[:, 0] == top2[:, 1]))
    if not (np.array_equal(lab, lh) and np.allclose(conf, ch, atol=1e-7)):
        fail("majority vote on the card differs from the host oracle")
    ds, ds_s = timed(lambda: agg.dawid_skene(votes))
    t0 = time.perf_counter()
    dsh = dawid_skene_host(votes, classes)
    host_s = time.perf_counter() - t0
    errs = {f: float(np.abs(getattr(ds, f) - getattr(dsh, f)).max())
            for f in ("posterior", "confusion", "prior")}
    same = bool(np.array_equal(ds.labels, dsh.labels))
    print(f"aggregator ({n} items, {workers} workers, {classes} classes, "
          f"{repeats} votes; {ties} rows tied at the top): majority exact, "
          f"{maj_s:.4f} s; ds max abs err {errs}, labels "
          f"{'identical' if same else 'DIFFER'}, {ds_s:.4f} s on the card "
          f"({agg.cfg.em_iters} EM iterations, pack {agg.cache_keys()}), "
          f"host float64 oracle {host_s:.2f} s", flush=True)
    if not same or max(errs.values()) > 1e-4:
        fail(f"Dawid-Skene on the card: labels identical {same}, errors "
             f"{errs} beyond atol 1e-4")


# the reference's fleet test specs (tests/test_orchestrator.py) at full
# size, the odd tenants on k-center so that both campaign kernels launch
FLEET_TENANTS = 8
# span names the CPU test finds in the reference's registry after the same
# noisy margin campaign (tests/test_torch_obs.py)
REFERENCE_SPANS = {"bootstrap", "iteration", "commit", "annotate", "fit",
                   "sweep"}


def fleet_specs(max_iters: int, eps=None, quality=None):
    from repro_torch.core import MCALConfig
    from repro_torch.core.tenant import TenantSpec
    return [TenantSpec(f"t{i}", priority=i % 3, seed=i, cfg=MCALConfig(
        eps_target=0.05 + 0.01 * (i % 4) if eps is None else eps, seed=i,
        metric="kcenter" if i % 2 else "margin", max_iters=max_iters,
        label_quality=quality)) for i in range(FLEET_TENANTS)]


def run_fleet(torch, mh, pd, x, y, trace_dir: Path, max_iters: int,
              seen: dict):
    """Eight live campaigns sharing one engine bundle on the card
    (``launch.orchestrator.build_fleet``, the engines at ``LiveTask``'s
    defaults), run concurrently, then serially: every tenant's trace must
    diff clean between the two, and t0 (margin) and t1 (k-center) run
    alone on private engines must diff clean against their fleet traces.
    Each ``fit_plan`` bucket is captured once over the concurrent fleet.
    Returns the kernels' launches in the concurrent run."""
    from repro_torch.core import AMAZON, LiveTask, MCALCampaign
    from repro_torch.launch.orchestrator import build_fleet
    from repro_torch.trace import TraceStore, diff

    specs = fleet_specs(max_iters)
    walls, launches, results = {}, None, {}
    for mode in ("concurrent", "serial"):
        d = trace_dir / f"fleet_{mode}"
        orch = build_fleet(x, y, specs, service=AMAZON, trace_dir=str(d),
                           concurrent=mode == "concurrent")
        restore = []
        if mode == "concurrent":
            restore = [record_shapes(mh, "margin_head", seen["margin_head"],
                                     margin_key),
                       record_shapes(pd, "pairwise_sqdist",
                                     seen["pairwise_sqdist"], pairwise_key)]
        torch.cuda.synchronize()
        mh.launches = 0
        pd.launches = 0
        t0 = time.perf_counter()
        try:
            results[mode] = orch.run()
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            got = {"margin_head": mh.launches,
                   "pairwise_sqdist": pd.launches}
            fit = orch.engines.fit
            buckets, captures = fit.cache_keys(), fit.captures
            graphs = sorted(fit._graphs)
        finally:
            for r in restore:
                r()
            orch.close()
        ends = {t: summary(r) for t, r in sorted(results[mode].items())}
        print(f"fleet {mode} ({FLEET_TENANTS} tenants, pool {len(x)}): "
              f"wall {walls[mode]:.2f} s, launches {got}, fit_plan "
              f"buckets {len(buckets)}, graphs captured {captures}",
              flush=True)
        for t, end in ends.items():
            print(f"fleet {mode} {t}: {end}", flush=True)
        if set(results[mode]) != {s.tenant_id for s in specs}:
            fail(f"the {mode} fleet committed {sorted(results[mode])}")
        for t, r in results[mode].items():
            if (r.labels < 0).any():
                fail(f"fleet {mode} {t} left rows unlabeled")
        if mode == "concurrent":
            launches = got
            if got["margin_head"] == 0 or got["pairwise_sqdist"] == 0:
                fail(f"the fleet launched {got}: a campaign kernel never "
                     f"ran on the fleet path")
            if fit.device.type == "cuda" and (captures != len(buckets)
                                              or graphs != buckets):
                fail(f"the concurrent fleet captured {captures} graphs for "
                     f"{len(buckets)} fit_plan buckets ({graphs} against "
                     f"{buckets})")
    for s in specs:
        d = diff(str(trace_dir / "fleet_concurrent" / f"{s.tenant_id}.jsonl"),
                 str(trace_dir / "fleet_serial" / f"{s.tenant_id}.jsonl"))
        if d is not None:
            fail(f"fleet tenant {s.tenant_id}, concurrent against serial: "
                 f"{d.describe()}")
        if not (results["concurrent"][s.tenant_id].labels
                == results["serial"][s.tenant_id].labels).all():
            fail(f"fleet tenant {s.tenant_id}: concurrent and serial labels "
                 f"differ")
    solo_wall = 0.0
    for s in specs[:2]:
        path = trace_dir / f"solo_{s.tenant_id}.jsonl"
        task = LiveTask(features=x, groundtruth=y, num_classes=10,
                        seed=s.seed)
        camp = MCALCampaign(task, AMAZON, s.cfg)
        trace = TraceStore(str(path), s.tenant_id)
        camp.attach_trace(trace)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = camp.run()
            torch.cuda.synchronize()
            solo_wall += time.perf_counter() - t0
        finally:
            camp.close()
            trace.close()
        d = diff(str(path), str(trace_dir / "fleet_concurrent"
                                / f"{s.tenant_id}.jsonl"))
        print(f"fleet solo {s.tenant_id} ({s.cfg.metric}) on private "
              f"engines: {summary(res)}, trace diff against the fleet "
              f"{'clean' if d is None else d.describe()}", flush=True)
        if d is not None:
            fail(f"solo {s.tenant_id} against its fleet trace: "
                 f"{d.describe()}")
    print(f"fleet walls: concurrent {walls['concurrent']:.2f} s, serial "
          f"{walls['serial']:.2f} s, solo t0 + t1 {solo_wall:.2f} s; every "
          f"tenant concurrent = serial, t0 and t1 = solo", flush=True)
    return launches


def noisy_service(seed=0):
    """The noisy campaign's annotation service: 5 workers, noise 0.2, 3
    votes a label, Dawid-Skene on the card."""
    from repro_torch.annotation import make_annotation_service
    from repro_torch.core import AMAZON
    return make_annotation_service(10, n_workers=5, noise=0.2, repeats=3,
                                   aggregator="ds", pricing=AMAZON,
                                   seed=seed)


# the live selection's candidates: LiveTask's defaults but the width
ARCH_WIDTHS = (32, 64, 128)
ARCH_REPLAY = ("cnn18", "resnet18", "resnet50")
# benchmarks/bench_table1.py PAPER (the paper's Table 1, amazon): MCAL's
# cost and savings with architecture selection
PAPER_TABLE1 = {"fashion": (400, 0.86), "cifar10": (792, 0.67),
                "cifar100": (1698, 0.29)}
# the reference's selections (select_architecture over ARCH_REPLAY, CPU
# JAX, seed 0, eps 0.05, amazon): winner, decision, |B|, |S|, cost and
# each candidate's iterations.  The emulator's error depends only on |B|,
# so k-center's picks cannot move these.
ARCH_REPLAY_CASES = {
    ("fashion", "margin"): ("resnet18", "hybrid", 8400, 48600, "827.70",
                            (4, 14, 4)),
    ("cifar10", "margin"): ("resnet18", "hybrid", 11000, 33580, "967.00",
                            (6, 9, 6)),
    ("cifar100", "margin"): ("resnet18", "hybrid", 3000, 6675, "1796.90",
                             (2, 4, 2)),
    ("cifar10", "kcenter"): ("resnet18", "hybrid", 11000, 33580, "967.00",
                             (6, 9, 6)),
}


def run_arch_selection(torch, mh, pd, x, y, max_iters: int, seen: dict):
    """Architecture selection (``select_architecture``) on the card.  Live:
    three MLP candidates (``LiveTask`` defaults, hidden 32, 64 and 128),
    each with its own scoring engine, sweep runner and fit engine, with
    margin and with k-center, each once synchronously and once with
    ``fit_async`` and ``sweep_async`` (every candidate's retrain at once,
    each engine capturing its own graphs): the two runs must end alike
    (winner, each candidate's C*, training and human spend, cost, labels),
    each engine capture each bucket it used once, and the error meet the
    target.  Replay: the paper's cnn18/resnet18/resnet50 calibrations on
    fashion, cifar10 and cifar100 with margin and cifar10 with k-center,
    each ending as the reference's selection.  Returns the launches of
    the live runs and of the replay runs."""
    from repro_torch.core import (AMAZON, LiveTask, MCALConfig,
                                  make_emulated_task, select_architecture)
    eps = 0.05
    live = {"margin_head": 0, "pairwise_sqdist": 0}
    replay = 0
    restore = [record_shapes(mh, "margin_head", seen["margin_head"],
                             margin_key),
               record_shapes(pd, "pairwise_sqdist", seen["pairwise_sqdist"],
                             pairwise_key)]
    try:
        for metric in ("margin", "kcenter"):
            runs = {}
            for mode in ("sync", "async"):
                tasks = {f"mlp-h{h}": LiveTask(
                    features=x, groundtruth=y, num_classes=10, hidden=h,
                    arch_name=f"mlp-h{h}") for h in ARCH_WIDTHS}
                spent = ({n: time_phases(torch, t) for n, t in tasks.items()}
                         if mode == "sync" else {})
                fast = mode == "async"
                cfg = MCALConfig(eps_target=eps, seed=0, metric=metric,
                                 max_iters=max_iters, fit_async=fast,
                                 sweep_async=fast)
                torch.cuda.synchronize()
                mh.launches = 0
                pd.launches = 0
                t0 = time.perf_counter()
                try:
                    winner, res, hist = select_architecture(tasks, AMAZON,
                                                            cfg)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    got = {"margin_head": mh.launches,
                           "pairwise_sqdist": pd.launches}
                finally:
                    for t in tasks.values():
                        t.close()
                for k, v in got.items():
                    live[k] += v
                runs[mode] = (winner, res, hist)
                print(f"arch selection live metric={metric} {mode}: winner "
                      f"{winner}, {summary(res)}, wall {wall:.2f} s, "
                      f"launches {got}; "
                      + "; ".join(f"{n} {len(h)} iterations, final C* "
                                  f"{h[-1].cstar:.2f}"
                                  for n, h in hist.items()), flush=True)
                for n, sp in spent.items():
                    print(f"arch selection live metric={metric} {n} seconds "
                          f"by phase: " + ", ".join(
                              f"{k} {v:.3f}" for k, v in sp.items() if v),
                          flush=True)
                for n, t in tasks.items():
                    fit = t._fit
                    if fit.captures != len(fit.cache_keys()) or \
                            sorted(fit._graphs) != fit.cache_keys():
                        fail(f"arch selection {metric} {mode} {n}: "
                             f"{fit.captures} graphs captured for the "
                             f"buckets {fit.cache_keys()}")
                if (res.labels < 0).any():
                    fail(f"arch selection {metric} {mode} left rows "
                         f"unlabeled")
                if not res.measured_error <= eps + 0.01:
                    fail(f"arch selection {metric} {mode} error "
                         f"{res.measured_error} > {eps + 0.01}")
                if got["margin_head"] == 0:
                    fail(f"margin_head never launched in the {metric} "
                         f"{mode} selection")
                if metric == "kcenter" and got["pairwise_sqdist"] == 0:
                    fail(f"pairwise_sqdist never launched in the k-center "
                         f"{mode} selection")
            (w_s, r_s, h_s), (w_a, r_a, h_a) = runs["sync"], runs["async"]
            fields = ("cstar", "training_spent", "human_spent")
            same = w_s == w_a and r_s.total_cost == r_a.total_cost and all(
                [getattr(r, f) for r in h_s[n]] ==
                [getattr(r, f) for r in h_a[n]]
                for n in h_s for f in fields) and \
                bool((r_s.labels == r_a.labels).all())
            print(f"arch selection live metric={metric}: async "
                  f"{'= sync' if same else 'DIFFERS from sync'}", flush=True)
            if not same:
                fail(f"arch selection {metric}: the async run ended "
                     f"{w_a} {summary(r_a)}, the sync run {w_s} "
                     f"{summary(r_s)}")

        for (dataset, metric), want in ARCH_REPLAY_CASES.items():
            tasks = {a: make_emulated_task(dataset, a, seed=0)
                     for a in ARCH_REPLAY}
            torch.cuda.synchronize()
            pd.launches = 0
            t0 = time.perf_counter()
            winner, res, hist = select_architecture(
                tasks, AMAZON, MCALConfig(eps_target=eps, seed=0,
                                          metric=metric))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = pd.launches
            replay += n
            got = (winner, res.decision, res.B_size, res.S_size,
                   f"{res.total_cost:.2f}",
                   tuple(len(hist[a]) for a in ARCH_REPLAY))
            cost, save = PAPER_TABLE1[dataset]
            full = tasks[winner].pool_size * AMAZON.price_per_label
            print(f"arch selection replay {dataset} metric={metric}: winner "
                  f"{winner}, cost {res.total_cost:.2f} (savings "
                  f"{1 - res.total_cost / full:.1%}), measured error "
                  f"{res.measured_error:.5f}, |B| {res.B_size}, |S| "
                  f"{res.S_size}, iterations {got[5]}, wall {wall:.3f} s, "
                  f"pairwise_sqdist launches {n}; paper: ${cost}, savings "
                  f"{save:.0%}", flush=True)
            if got != want:
                fail(f"arch selection replay {dataset} {metric} ended "
                     f"{got}, the reference {want}")
            if (res.labels < 0).any():
                fail(f"arch selection replay {dataset} {metric} left rows "
                     f"unlabeled")
            # tests/test_mcal.py holds the margin selection on cifar10 at
            # 0.055; k-center machine-labels other rows (the reference's
            # own k-center selection: 0.0566), so it is held at the target
            limit = 0.055 if metric == "margin" else eps + 0.01
            if not res.measured_error <= limit:
                fail(f"arch selection replay {dataset} {metric} error "
                     f"{res.measured_error} > {limit}")
            if metric == "kcenter" and n == 0:
                fail("pairwise_sqdist never launched in the replay k-center "
                     "selection")
    finally:
        for r in restore:
            r()
    return live, replay


def run_capped_fleet(torch, mh, x, y, trace_dir: Path, max_iters: int):
    """The eight specs sharing one noisy annotation service (each tenant
    an ``AnnotationSession`` of it), eps raised to 0.1 as in the noisy
    campaign, under a global ceiling of half the fleet's bootstrap spend:
    the downgrade cascade walks pause, shrink_votes and force_commit.  Run
    concurrently twice: the fleet traces diff clean under ``FLEET_KINDS``
    with equal downgrade sequences, and every tenant's votes equal its
    ``buy_labels`` charges.  Returns margin_head's launches in the first
    run."""
    from repro_torch.core import AMAZON
    from repro_torch.core.tenant import (DOWNGRADE_ACTIONS, FLEET_KINDS,
                                         downgrade_sequence)
    from repro_torch.launch.orchestrator import build_fleet
    from repro_torch.trace import diff

    pool = len(x)
    labels0 = max(int(round(0.05 * pool)), 16) + \
        max(int(round(0.01 * pool)), 8)
    ceiling = FLEET_TENANTS / 2 * labels0 * 3 * AMAZON.price_per_label
    seqs, launches = [], 0
    for run in (1, 2):
        svc = noisy_service()
        specs = fleet_specs(max_iters, eps=0.1, quality=svc.calibrate())
        d = trace_dir / f"capped_{run}"
        orch = build_fleet(x, y, specs, service=AMAZON, trace_dir=str(d),
                           global_budget=ceiling, annotation_service=svc)
        torch.cuda.synchronize()
        mh.launches = 0
        t0 = time.perf_counter()
        try:
            res = orch.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = mh.launches
            votes = {t.tenant_id: (t.campaign.task.annotation.votes_bought,
                                   t.campaign.pool.ledger.human_votes)
                     for t in orch.tenants}
            spent = orch.controller.spent()
        finally:
            orch.close()
        if run == 1:
            launches = got
        seq = downgrade_sequence(str(d / "fleet.jsonl"))
        seqs.append(seq)
        actions = [e["action"] for e in seq]
        print(f"capped fleet run {run} (ceiling {ceiling:.2f}, 8 sessions "
              f"of one service): wall {wall:.2f} s, spent {spent:.2f}, "
              f"margin_head launches {got}, downgrades "
              + ", ".join(f"r{e['round']} {e['action']} {e['tenant']}"
                          for e in seq), flush=True)
        print(f"capped fleet run {run} votes (session, buy_labels): "
              f"{votes}", flush=True)
        if set(actions) != set(DOWNGRADE_ACTIONS):
            fail(f"the capped fleet's downgrades {sorted(set(actions))} "
                 f"miss one of {DOWNGRADE_ACTIONS}")
        for t, (sold, charged) in votes.items():
            if sold != charged or sold <= 0:
                fail(f"capped fleet {t}: the session sold {sold} votes, "
                     f"buy_labels charged {charged}")
        if set(res) != {s.tenant_id for s in specs}:
            fail(f"the capped fleet committed {sorted(res)}")
        if got == 0:
            fail("margin_head never launched in the capped fleet")
    d = diff(str(trace_dir / "capped_1" / "fleet.jsonl"),
             str(trace_dir / "capped_2" / "fleet.jsonl"), kinds=FLEET_KINDS)
    print(f"capped fleet: two runs' downgrade sequences "
          f"{'equal' if seqs[0] == seqs[1] else 'DIFFER'}, fleet traces "
          f"{'clean' if d is None else d.describe()}", flush=True)
    if seqs[0] != seqs[1] or d is not None:
        fail("the capped fleet's two runs made different budget decisions")
    return launches


def run_chaos_and_instrumented(torch, mh, x, y, trace_dir: Path,
                               max_iters: int, seen: set):
    """The noisy live margin campaign through ``launch.label.run_campaign``
    (``sweep_async``, ``fit_async``): fault-free; under the launcher's
    ``--chaos`` plan (``FaultPlan.standard_transient(0)`` and a
    ``RetryPolicy``), where every site of the plan must fire; killed at
    its third iteration with ``--autosave`` and resumed; with metrics
    interleaved into its trace, an SLO spec and a Prometheus snapshot; and
    with that plus ``--profile`` over its first iteration, whose Chrome
    trace must hold ``margin_head``'s kernel.  Every run diffs clean
    against the fault-free one.  Returns margin_head's launches in the
    chaos and the instrumented runs."""
    from repro_torch.core import AMAZON, LiveTask, MCALConfig
    from repro_torch.faults import (FaultInjector, FaultPlan, FaultRule,
                                    InjectedKill, RetryPolicy)
    from repro_torch.launch.label import run_campaign
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.profiling import trace_path
    from repro_torch.trace import diff, read_trace

    def task():
        return LiveTask(features=x, groundtruth=y, num_classes=10,
                        annotation=noisy_service())
    first = task()
    cfg = MCALConfig(eps_target=0.1, seed=0, max_iters=max_iters,
                     label_quality=first.annotation.calibrate(),
                     sweep_async=True, fit_async=True)

    def run(name, t=None, **kw):
        path = trace_dir / f"{name}.jsonl"
        torch.cuda.synchronize()
        mh.launches = 0
        t0 = time.perf_counter()
        res, camp = run_campaign(t or task(), AMAZON, cfg,
                                 trace_path=str(path),
                                 campaign_id="live-noisy-s0", **kw)
        torch.cuda.synchronize()
        return res, camp, path, time.perf_counter() - t0, mh.launches

    def clean_against(path, what):
        d = diff(str(path), str(plain_path))
        if d is not None:
            fail(f"{what} trace against the fault-free one: {d.describe()}")

    plain, _, plain_path, plain_wall, _ = run("plain", first)
    print(f"chaos baseline (noisy margin campaign, sweep_async, fit_async): "
          f"{summary(plain)}, wall {plain_wall:.2f} s", flush=True)

    plan = FaultPlan.standard_transient(0)
    inj = FaultInjector(plan)
    fired = MetricsRegistry()
    inj.attach_metrics(fired)
    restore = record_shapes(mh, "margin_head", seen, margin_key)
    res, _, path, wall, chaos_launches = run("chaos", faults=inj,
                                             retry=RetryPolicy(seed=0))
    restore()
    by_site = {}
    for c in fired.snapshot()["counters"]:
        if c["name"] == "faults_injected_total":
            key = f"{c['labels']['site']}/{c['labels']['kind']}"
            by_site[key] = by_site.get(key, 0) + int(c["value"])
    retries = sum(e.kind == "retry" for e in read_trace(str(path)))
    print(f"chaos (standard_transient seed 0 + RetryPolicy): {summary(res)}, "
          f"wall {wall:.2f} s, faults_injected {inj.fired} by site {by_site}, "
          f"sites ticked {inj.counters()}, {retries} retry events, "
          f"margin_head launches {chaos_launches}", flush=True)
    clean_against(path, "chaos")
    if summary(res) != summary(plain) or not (res.labels
                                              == plain.labels).all():
        fail(f"chaos campaign ended {summary(res)}, fault-free "
             f"{summary(plain)}")
    missing = {r.site for r in plan.rules} - {k.split("/")[0]
                                              for k in by_site}
    if missing:
        fail(f"sites of the chaos plan that never fired: {sorted(missing)}")
    if chaos_launches == 0:
        fail("margin_head never launched in the chaos campaign")

    side = trace_dir / "autosave.json"
    killer = FaultInjector(FaultPlan(rules=(
        FaultRule("campaign.iteration", "kill", at=(2,)),)))
    killed = False
    try:
        run("kill", faults=killer, autosave_path=str(side))
    except InjectedKill:
        killed = True
    saved = side.exists()
    res, hops = None, 0
    while res is None:
        res, _, path, _, _ = run("kill", autosave_path=str(side))
        hops += 1
        if hops > 5:
            fail("the killed campaign never finished")
    print(f"kill at iteration 2 + autosave: killed {killed}, sidecar "
          f"written {saved}, resumed in {hops} run(s): {summary(res)}",
          flush=True)
    if not (killed and saved) or side.exists():
        fail("the kill point did not fire, or the sidecar was not written "
             "and spent")
    clean_against(path, "killed and resumed")
    if summary(res) != summary(plain):
        fail(f"killed campaign resumed to {summary(res)}")

    slo = trace_dir / "slo.json"
    slo.write_text(json.dumps({"cost_per_label_max": 0.02,
                               "projected_quality_min": 0.99}))
    prom = trace_dir / "metrics.prom"
    inst = trace_dir / "instrumented.jsonl"
    res, camp, path, inst_wall, inst_launches = run(
        "instrumented", metrics_path=str(inst), prom_path=str(prom),
        slo_path=str(slo))
    snap = camp.metrics.snapshot()
    spans = {h["labels"]["name"] for h in snap["histograms"]
             if h["name"] == "span_seconds"}
    events = read_trace(str(path))
    fit_spans = [e.payload for e in events
                 if e.kind == "metric_span" and e.payload["name"] == "fit"]
    fenced = sum(bool(p["fenced"]) for p in fit_spans)
    alerts = sum(e.kind in ("alert", "slo_breach") for e in events)
    print(f"instrumented (metrics in the trace, SLO, prom): {summary(res)}, "
          f"wall {inst_wall:.2f} s against {plain_wall:.2f} s plain "
          f"(ratio {inst_wall / plain_wall:.4f}), spans {sorted(spans)}, "
          f"fit spans fenced {fenced}/{len(fit_spans)}, health "
          f"{camp.health.counts()}, {alerts} alert events, prom "
          f"{prom.stat().st_size if prom.exists() else 0} bytes, "
          f"margin_head launches {inst_launches}", flush=True)
    clean_against(path, "instrumented")
    if not REFERENCE_SPANS <= spans:
        fail(f"the registry lacks spans {sorted(REFERENCE_SPANS - spans)}")
    if not fit_spans or fenced != len(fit_spans):
        fail(f"fit spans fenced {fenced} of {len(fit_spans)}")
    if not prom.exists() or inst_launches == 0:
        fail("no Prometheus snapshot, or margin_head never launched")

    prof = trace_dir / "profile"
    res, _, path, prof_wall, _ = run(
        "profiled", metrics_path=str(trace_dir / "profiled.jsonl"),
        prom_path=str(prom), slo_path=str(slo), profile_dir=str(prof),
        profile_iter=1)
    clean_against(path, "profiled")
    chrome = Path(trace_path(str(prof)))
    if not chrome.exists():
        fail("--profile wrote no trace")
    kernels = [e for e in json.loads(chrome.read_text())["traceEvents"]
               if str(e.get("cat", "")).lower() == "kernel"]
    ours = sorted({e["name"] for e in kernels
                   if "margin_head_slice_kernel" in e["name"]})
    print(f"profiled iteration 1: wall {prof_wall:.2f} s, {len(kernels)} "
          f"CUDA kernel events, margin_head symbols {ours[:2]}", flush=True)
    if not ours:
        fail("the profile's CUDA kernel events hold no margin_head kernel")
    return chaos_launches, inst_launches


def check_retrain_graphs(torch, task, x, y, sizes):
    """One retrain per bucket the campaigns used, through a fresh engine's
    CUDA graph and through the eager loop: params and losses bit-equal.
    Prints the graph's capture, its replay and the eager loop's time."""
    from repro_torch.training.fit_device import FitEngine, fit_plan

    by_key = {}
    for n in sizes:
        by_key.setdefault(fit_plan(n, task.batch_size), n)
    for key, n in sorted(by_key.items()):
        eng = FitEngine(task.model, task.tc, task._fit.cfg, device="cuda")

        def timed(fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        _, capture = timed(eng.warm, [key])
        (pg, lg), graph_s = timed(eng.fit, 0, x[:n], y[:n])
        (pe, le), eager_s = timed(eng.fit_eager, 0, x[:n], y[:n])
        same = torch.equal(lg, le) and all(torch.equal(pg[k], pe[k])
                                            for k in pe)
        print(f"retrain bucket {key} (n {n}, {lg.numel()} steps): capture "
              f"{capture:.3f} s, graph replay {graph_s:.3f} s, eager loop "
              f"{eager_s:.3f} s, params and losses "
              f"{'bit-equal' if same else 'DIFFER'}", flush=True)
        if not same:
            worst = max(float((pg[k] - pe[k]).abs().max()) for k in pe)
            fail(f"retrain bucket {key}: the graph's params differ from the "
                 f"eager loop's by up to {worst}, losses by "
                 f"{float((lg - le).abs().max())}")


def check_paged_sinks(torch, np, task, x):
    """The paged RankTop1Sink, FeatureSink and TopKSink against the
    engine's unpaged pass, exactly, on the trained margin classifier: the
    whole pool, a remaining pool whose last page holds more than a
    microbatch, and one whose last page holds less."""
    from repro_torch.serving.sweep import FeatureSink, RankTop1Sink, TopKSink
    engine, runner, params = task._engine, task._sweep, task._params
    P, mb = runner.cfg.page_rows, engine.cfg.microbatch
    for n in (len(x), 47_500, 5 * P + mb // 2):
        rows = x[:n]
        stats, feats = engine.score(params, rows)
        t0 = time.perf_counter()
        order, top1 = runner.run(params, rows, RankTop1Sink("margin"))
        torch.cuda.synchronize()
        rank_s = time.perf_counter() - t0
        want = np.argsort(-stats.margin.double().cpu().numpy(),
                          kind="stable")
        paged = runner.run(params, rows, FeatureSink())
        ok = (np.array_equal(order, want)
              and np.array_equal(top1, stats.top1.cpu().numpy())
              and torch.equal(paged, feats)
              and np.array_equal(runner.run(params, rows, TopKSink(500)),
                                 engine.top_k(params, rows, 500)))
        print(f"paged sinks n {n} (pages of {P}, last page "
              f"{n - (runner.n_pages(n) - 1) * P} rows): rank, features and "
              f"top-k {'equal' if ok else 'DIFFER FROM'} the unpaged pass; "
              f"rank sweep {rank_s:.4f} s", flush=True)
        if not ok:
            fail(f"paged sinks differ from the unpaged pass at n {n}")


def per_forward(cfg) -> dict:
    """Kernel launches of one forward pass of a served LM: zamba2's shared
    attention block once every ``shared_attn_every`` Mamba2 layers (an
    ``ssd_scan`` each), mamba2's ``ssd_scan`` once a layer and no
    attention, a dense, MoE or VLM model's attention once a layer,
    whisper's once an encoder layer and twice a decoder layer (self and
    cross)."""
    if cfg.family == "hybrid":
        n = {"flash_attention": cfg.num_layers // cfg.shared_attn_every,
             "ssd_scan": cfg.num_layers}
    elif cfg.family == "ssm":
        n = {"flash_attention": 0, "ssd_scan": cfg.num_layers}
    elif cfg.family == "audio":   # the encoder's, each decoder layer's two
        n = {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers,
             "ssd_scan": 0}
    else:
        n = {"flash_attention": cfg.num_layers, "ssd_scan": 0}
    # serving takes no gradient
    return dict(n, flash_attention_bwd=0, ssd_scan_bwd=0)


def run_serving(torch, np, mods, arch: str, batch: int, prompt_len: int,
                gen: int, seen: dict, pool_pass=None, layers: int = 0,
                train=None, extra=None):
    """``arch``'s full config, bf16, through ServeEngine; returns the
    serving path's launch counts.  ``seen`` collects kernel shapes.
    ``pool_pass``, ``extra`` and ``train``, where given, are called in
    that order with (model, params) before the model is freed (the engine
    already dropped); the first and the last each return their own launch
    counts (so a training phase reuses the served weights, and may take
    them over), ``extra`` (a mesh check) keeps its own.
    ``layers``, where given, cuts the depth (every width stays the
    config's).  A VLM's requests carry ``frontend_tokens`` random fp32
    patch embeddings each (seed 0), which its cache holds before the
    prompt; an audio model's carry ``encoder_tokens`` random fp32 frame
    embeddings each (seed 0), which its cross-attention cache holds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.scoring import resolve_head_weight
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"serve {arch} init seconds: {model.init_seconds:.3f} "
          f"({n_params:,} params, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}; {CARD})", flush=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    patches = cfg.frontend_tokens   # a VLM's patch embeddings a request
    req = {"tokens": tokens}
    if patches:
        req["patch_embeds"] = rng.normal(
            size=(batch, patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":       # whisper's frame embeddings a request
        req["audio_frames"] = rng.normal(
            size=(batch, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    seq = patches + prompt_len        # positions a request fills
    engine = ServeEngine(model, params, max_seq=seq + gen + 8,
                         batch_size=batch, device="cuda")
    per_pass = per_forward(cfg)
    restore = [record_shapes(mods["margin_head"], "margin_head",
                             seen["margin_head"], margin_key),
               record_shapes(mods["flash_attention"], "flash_attention",
                             seen["flash_attention"], flash_key),
               record_shapes(mods["ssd_scan"], "ssd_scan", seen["ssd_scan"],
                             ssd_key)]
    total = dict.fromkeys(mods, 0)

    def counted(label, fn, want):
        """Run one pass with the counts zeroed just before and read just
        after; ``want`` is the exact count of each kernel it must launch."""
        torch.cuda.synchronize()
        for m in mods.values():
            m.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: m.launches for k, m in mods.items()}
        for k, v in got.items():
            total[k] += v
        print(f"serve {arch} {label}: {secs:.3f} s, launches {got}",
              flush=True)
        for k, n in want.items():
            if got[k] != n:
                fail(f"serve {arch} {label}: {k} launched {got[k]} times, "
                     f"want {n}")
        return out, secs

    batch_t = {k: torch.as_tensor(v, device="cuda") for k, v in req.items()}
    hidden, _ = counted("forward", lambda: model.forward(params, batch_t),
                        dict(per_pass, margin_head=0))
    last = model.logits(params, hidden[:, -1:, :])
    want_first = torch.argmax(last[:, -1, :], dim=-1).to(torch.int32)
    if hidden.shape != (batch, seq, cfg.d_model) or \
            not bool(torch.isfinite(hidden).all()):
        fail(f"serve {arch} forward: hidden {tuple(hidden.shape)} not "
             f"finite")
    del hidden

    stats, secs = counted("score", lambda: engine.score(req),
                          dict(per_pass, margin_head=1))
    print(f"serve {arch} score rows/s: {batch / secs:.3f} ({CARD})",
          flush=True)
    if not all(bool(torch.isfinite(a).all()) for a in stats[:3]) or \
            not bool(((stats.top1 >= 0) & (stats.top1 < cfg.vocab_size))
                     .all()) or stats.margin.shape != (batch,):
        fail(f"serve {arch} score: bad stats {stats}")
    print(f"serve {arch} score margin {stats.margin.tolist()} top1 "
          f"{stats.top1.tolist()}", flush=True)
    # the pool pass: batches of requests streamed by score_pool in pages
    # of one batch, each page the score step's own batch shape
    pages = 4
    pool = {"tokens": rng.integers(0, cfg.vocab_size,
                                   (pages * batch, prompt_len))}
    if patches:
        pool["patch_embeds"] = rng.normal(
            size=(pages * batch, patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        pool["audio_frames"] = rng.normal(
            size=(pages * batch, cfg.encoder_tokens,
                  cfg.d_model)).astype(np.float32)
    pooled, secs = counted(
        "score_pool", lambda: engine.score_pool(pool, page_rows=batch),
        {k: v * pages for k, v in dict(per_pass, margin_head=1).items()})
    print(f"serve {arch} score_pool rows/s: {pages * batch / secs:.3f} "
          f"({pages} pages of {batch} rows of {prompt_len} tokens; launches "
          f"per page {dict(per_pass, margin_head=1)}; {CARD})", flush=True)
    for lo in range(0, pages * batch, batch):
        want = engine.score({k: v[lo:lo + batch] for k, v in pool.items()})
        if not all(torch.equal(p[lo:lo + batch], w)
                   for p, w in zip(pooled, want)):
            fail(f"serve {arch} score_pool rows {lo}-{lo + batch} differ "
                 f"from score on that batch")
    print(f"serve {arch} score_pool: each page's stats equal score on its "
          f"batch", flush=True)
    engine.close()
    # the head's operand cast (the reference's w.astype(float32)): the
    # bf16 lm_head read and an fp32 copy written, every score pass; a tied
    # head (the embedding's transpose) is then made contiguous for the
    # kernel, a second fp32 copy
    w_head = resolve_head_weight(cfg, params)

    def cast():
        return w_head.float().contiguous()
    cast_ms = median_ms(torch, cast, reps=10, warmup=2)
    cast_dev = device_ms(torch, cast, reps=5)
    # bf16 read, fp32 written (and read and written again when tied)
    nbytes = (6 if w_head.is_contiguous() else 14) * w_head.numel()
    print(f"serve {arch} score head cast {tuple(w_head.shape)} "
          f"{w_head.dtype} -> fp32 (contiguous {w_head.is_contiguous()}): "
          f"{cast_ms:.4f} ms events, device {cast_dev:.4f} ms, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)", flush=True)

    (_, cache, pos), secs = counted(
        "prefill", lambda: engine.prefill(req), dict(per_pass, margin_head=0))
    if pos != seq:
        fail(f"serve {arch} prefill: the cache holds {pos} positions, want "
             f"{seq}")
    # positions filled a second, the patches included
    print(f"serve {arch} prefill tokens/s: {batch * seq / secs:.1f} "
          f"({CARD})", flush=True)
    del cache

    decode_s = []
    step = engine.decode

    def timed_decode(*args):
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out
    engine.decode = timed_decode
    out, secs = counted("generate", lambda: engine.generate(req, gen),
                        dict(per_pass, margin_head=0))
    # back to the class's method: a bound method kept on the instance is a
    # cycle that holds the engine, and its params, past this function
    # until the cyclic collector runs
    del engine.decode, step, timed_decode
    print(f"serve {arch} decode tokens/s: "
          f"{batch * len(decode_s) / sum(decode_s):.1f} ({len(decode_s)} "
          f"steps of {batch} rows; {CARD})", flush=True)
    print(f"serve {arch} max_memory_allocated bytes: "
          f"{torch.cuda.max_memory_allocated()} ({CARD})", flush=True)
    if out.shape != (batch, gen) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"serve {arch} generate: bad tokens {tuple(out.shape)}")
    if not torch.equal(out[:, 0], want_first):
        fail(f"serve {arch} generate: first tokens {out[:, 0].tolist()} "
             f"differ from the forward pass's argmax {want_first.tolist()}")
    print(f"serve {arch} generated {tuple(out.shape)}, first tokens "
          f"{out[:, 0].tolist()} equal the forward argmax", flush=True)
    for r in restore:
        r()
    # where the time goes: one score pass, one forward pass and one decode
    # step, profiled outside the counted passes
    profile_pass(torch, f"{arch} score", lambda: engine.score(req))
    profile_pass(torch, f"{arch} forward",
                 lambda: model.forward(params, batch_t))
    logits, cache, pos = engine.prefill(req)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    profile_pass(torch, f"{arch} decode step",
                 lambda: engine.decode(cache, tok, pos))
    del logits, cache, batch_t, engine, w_head, cast
    pooled_launches = trained_launches = None
    if pool_pass is not None:
        pooled_launches = pool_pass(model, params)
    if extra is not None:
        extra(model, params)
    if train is not None:
        trained_launches = train(model, params)
    del params, stats, pooled, out, last, want_first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {arch} freed: {torch.cuda.memory_allocated()} bytes still "
          f"allocated", flush=True)
    if train is not None:
        return total, pooled_launches, trained_launches
    return total, pooled_launches


def pool_pass(torch, np, mods, seen: dict, rows: int = 1024, seq: int = 256,
              microbatch: int = 64, page_rows: int = 256, k: int = 100):
    """MCAL's LLM-labeler pass over a ``rows`` x ``seq`` int32 token pool
    (seed 0) through ``PoolScoringEngine(microbatch)``: the M(.) top-k by
    margin and the L(.) ranking, unpaged and through ``PoolSweepRunner``
    in pages of ``page_rows``; paged must equal unpaged exactly, in index
    order.  The engine's first microbatch is held against the JAX
    package's host oracle's arithmetic (``score_pool_reference``: the same
    forward, the head as a plain fp32 product).  Returns a function of
    (model, params) that runs it and returns its launch counts."""
    from repro_torch.core.scoring import (PoolScoringEngine, ScoringConfig,
                                          pack_shape, resolve_head_weight,
                                          score_pool_reference)
    from repro_torch.serving.sweep import (EngineSweepAdapter,
                                           PoolSweepRunner, RankTop1Sink,
                                           SweepConfig, TopKSink)

    def run(model, params):
        cfg = model.cfg
        pool = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (rows, seq)).astype(np.int32)
        engine = PoolScoringEngine(model, ScoringConfig(
            microbatch=microbatch), device="cuda")
        runner = PoolSweepRunner(EngineSweepAdapter(engine),
                                 SweepConfig(page_rows=page_rows))
        # microbatches swept: the pow2 bucketing of the pool, or of each
        # page
        n_mb = pack_shape(rows, microbatch)[0]
        paged_mb = sum(pack_shape(min(page_rows, rows - lo), microbatch)[0]
                       for lo in range(0, rows, page_rows))
        per_mb = dict(per_forward(cfg), margin_head=1)
        restore = [record_shapes(mods["margin_head"], "margin_head",
                                 seen["margin_head"], margin_key),
                   record_shapes(mods["flash_attention"], "flash_attention",
                                 seen["flash_attention"], flash_key),
                   record_shapes(mods["ssd_scan"], "ssd_scan",
                                 seen["ssd_scan"], ssd_key)]
        engine.top_k(params, pool[:microbatch], k)   # cuBLAS settles
        total = dict.fromkeys(mods, 0)
        out, secs = {}, {}
        passes = (
            ("top_k", lambda: engine.top_k(params, pool, k, "margin")),
            ("rank_confident", lambda: engine.rank_confident(params, pool,
                                                             "margin")),
            ("paged top_k", lambda: runner.run(params, pool,
                                               TopKSink(k, "margin"))),
            ("paged rank_confident", lambda: runner.run(
                params, pool, RankTop1Sink("margin"))[0]))
        for label, fn in passes:
            mbs = paged_mb if label.startswith("paged") else n_mb
            torch.cuda.synchronize()
            for m in mods.values():
                m.launches = 0
            t0 = time.perf_counter()
            out[label] = fn()
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            got = {name: m.launches for name, m in mods.items()}
            for name, v in got.items():
                total[name] += v
            print(f"pool pass {cfg.name} {label}: {secs[label]:.3f} s, "
                  f"{rows / secs[label]:.1f} rows/s, launches {got}",
                  flush=True)
            for name, n in per_mb.items():
                if got[name] != n * mbs:
                    fail(f"pool pass {label}: {name} launched {got[name]} "
                         f"times, want {n * mbs}")
        for r in restore:
            r()
        runner.close()
        for a, b in (("top_k", "paged top_k"),
                     ("rank_confident", "paged rank_confident")):
            if not np.array_equal(out[a], out[b]):
                fail(f"pool pass: {b} differs from the unpaged {a}")
        top, order = out["top_k"], out["rank_confident"]
        if top.shape != (k,) or len(set(top.tolist())) != k or \
                sorted(order.tolist()) != list(range(rows)):
            fail(f"pool pass: top-{k} {top.shape} or the ranking is not a "
                 f"set of distinct pool rows")
        print(f"pool pass {cfg.name}: paged = unpaged (top-{k} by margin "
              f"and the ranking of {rows} rows, pages of {page_rows}, "
              f"microbatch {microbatch}); top-{k} head {top[:8].tolist()}",
              flush=True)
        # the engine against the oracle's arithmetic on one microbatch:
        # the forward is the same launch for launch, the head a plain
        # fp32 product; the kernel's tolerance (check_margin_head)
        stats, _ = engine.score(params, pool[:microbatch])
        ref_stats, _ = score_pool_reference(model, params, pool[:microbatch],
                                            device="cuda")
        for name, tol in (("margin", 5e-5), ("entropy", 5e-4),
                          ("max_logprob", 5e-5)):
            g = getattr(stats, name).cpu().numpy()
            r = getattr(ref_stats, name)
            if not np.isfinite(g).all() or \
                    not (np.abs(g - r) <= tol + tol * np.abs(r)).all():
                fail(f"pool pass {name}: max err {np.abs(g - r).max()} "
                     f"beyond atol = rtol = {tol}")
        # top1 may part only where the oracle's top two logits nearly tie
        split = (stats.top1.cpu().numpy() != ref_stats.top1) & \
            (ref_stats.margin > 1e-4)
        if split.any():
            fail(f"pool pass: top1 differs from the oracle's at rows "
                 f"{np.nonzero(split)[0].tolist()}")
        print(f"pool pass {cfg.name}: the first microbatch's stats agree "
              f"with score_pool_reference", flush=True)
        # the head's fp32 copy each microbatch makes (the reference's
        # arithmetic), against the top-k pass's wall
        w = resolve_head_weight(cfg, params)
        cast_ms = median_ms(torch, lambda: w.float(), reps=10, warmup=2)
        share = cast_ms * n_mb / 1e3 / secs["top_k"]
        print(f"pool pass {cfg.name}: head cast {cast_ms:.4f} ms x {n_mb} "
              f"microbatches = {100 * share:.2f}% of the top_k pass",
              flush=True)
        del engine, runner
        return total
    return run


def _forever(loader):
    while True:
        yield from loader.epoch()


def _record_losses(trainer, losses: list, secs: list = None):
    """Wrap the trainer's step so each step's loss (read back, which
    waits for the step) and wall seconds are kept."""
    step_fn = trainer.step_fn

    def step(state, batch):
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        if secs is not None:
            secs.append(time.perf_counter() - t0)
        return state, met
    trainer.step_fn = step
    return trainer


def _zero(torch, mods):
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0


def cut_layers(model, params, layers: int):
    """``model`` cut to its first ``layers`` layers, and ``params`` cut to
    them: every leaf the cut model's specs stack on a shorter leading axis
    is a copy of its first ``layers`` entries, the others are kept whole.
    ``params`` is emptied, so the layers past the cut are freed once the
    caller holds them nowhere else."""
    import dataclasses

    from repro_torch.models import param as P
    from repro_torch.models.registry import get_model
    cut = get_model(dataclasses.replace(model.cfg, num_layers=layers))
    shapes = {k: tuple(sp.shape) for k, sp in P.iter_specs(cut.specs)}
    if sorted(shapes) != sorted(params):
        fail(f"cut_layers {model.cfg.name}: the cut model's leaves differ")
    kept = {k: v[:layers].clone() if tuple(v.shape) != shapes[k] else v
            for k, v in params.items()}
    params.clear()
    return cut, kept


def train_lm(torch, np, mods, seen: dict, steps: int = 6, batch: int = 8,
             seq: int = 2048, lr: float = 1e-4,
             moment_dtype: str = "float32", step_secs: list = None,
             layers: int = 0, loss_share: bool = False):
    """A hook for ``run_serving``: train the served model (a token family at
    its full config or width, the served bf16 weights from ``Model.init(seed
    0)``: qwen2-1.5b, mamba2-1.3b, zamba2-2.7b; gemma3-4b cut to ``layers``
    of its layers by :func:`cut_layers`) for ``steps`` steps through
    ``Trainer``: ``paper_steps`` over ``steps`` from ``lr`` (at 3e-4 and
    1e-3 the first steps' losses spiked on qwen2's random weights before
    falling back, on the card), ``batch`` sequences of ``seq`` tokens a step
    from ``make_lm_tokens`` (seed 0) through ``ShardedLoader``, no
    checkpoint, the config's ``remat="layer"`` and ``logits_chunk``, the
    optimizer's first moments in ``moment_dtype``.  Prints each step's
    loss, seconds and tokens/s, the peak device memory and the profile of
    one more step (its result dropped); fails unless every loss is finite,
    the last is below the first and each backward kernel ran once a step
    for each launch of its forward in a served forward pass (attention's
    once a layer, or once a shared-block application in zamba2; the SSD
    scan's once a Mamba2 layer).  Each step's seconds are added to
    ``step_secs`` where it is given.  With ``loss_share`` the loss alone
    (the chunked cross-entropy's forward and backward on random bf16 final
    hidden states through the served head, at the step's tokens) is timed
    once more after the steps, and its share of the steps' median printed.
    Returns the launch counts."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.trainer import Trainer, TrainerConfig

    def run(model, params):
        depth = model.cfg.num_layers
        if layers:
            model, params = cut_layers(model, params, layers)
        cfg = model.cfg
        t0 = time.perf_counter()
        toks = make_lm_tokens(batch * steps, seq + 1, cfg.vocab_size, seed=0)
        loader = ShardedLoader({"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]}, batch, seed=0,
                               device="cuda")
        print(f"train {cfg.name}: {toks.shape} tokens made in "
              f"{time.perf_counter() - t0:.3f} s; remat {cfg.remat}, "
              f"logits_chunk {cfg.logits_chunk}", flush=True)
        tc = TrainConfig(learning_rate=lr, schedule="paper_steps",
                         total_steps=steps, moment_dtype=moment_dtype)
        restore = [record_shapes(mods["flash_attention_bwd"],
                                 "flash_attention_bwd",
                                 seen["flash_attention_bwd"], flash_bwd_key),
                   record_shapes(mods["flash_attention"], "flash_attention",
                                 seen["flash_attention"], flash_key),
                   record_shapes(mods["ssd_scan_bwd"], "ssd_scan_bwd",
                                 seen["ssd_scan_bwd"], ssd_bwd_key)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        trainer = _record_losses(Trainer(
            model, tc, TrainerConfig(max_steps=steps, log_every=0),
            log_fn=lambda m: print(f"train {cfg.name} {m}", flush=True),
            device="cuda", params=params), losses, secs)
        _zero(torch, mods)
        t0 = time.perf_counter()
        trainer.fit(_forever(loader))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: m.launches for k, m in mods.items()}
        for r in restore:
            r()
        if step_secs is not None:
            step_secs.extend(secs)
        for i, (loss, sec) in enumerate(zip(losses, secs)):
            print(f"train {cfg.name} step {i + 1}: loss {loss!r}, "
                  f"{sec:.3f} s, {batch * seq / sec:.1f} tokens/s ({CARD})",
                  flush=True)
        print(f"train {cfg.name}: {steps} steps in {wall:.3f} s, "
              f"{batch * seq * steps / wall:.1f} tokens/s overall, steps "
              f"2-{steps} {batch * seq * (steps - 1) / sum(secs[1:]):.1f} "
              f"tokens/s; max_memory_allocated bytes "
              f"{torch.cuda.max_memory_allocated()}; {cfg.num_layers} "
              f"layers" + (f" (cut from {depth})" if layers else "")
              + f", moments {moment_dtype}; launches {got} ({CARD})",
              flush=True)
        if len(losses) != steps or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            fail(f"train {cfg.name}: losses {losses} are not finite and "
                 f"falling")
        per_pass = per_forward(cfg)
        for fwd in ("flash_attention", "ssd_scan"):
            want = per_pass[fwd] * steps
            if got[fwd + "_bwd"] != want or got[fwd] < want:
                fail(f"train {cfg.name}: launches {got}, want {fwd}_bwd "
                     f"{want} times")
        # where a step's time goes: one more step, profiled, its result
        # dropped
        step = make_train_step(model, tc)
        batch_1 = next(iter(loader.epoch()))
        profile_pass(torch, f"{cfg.name} train step",
                     lambda: step(trainer.state, batch_1))
        if loss_share:
            ms = loss_ms(torch, model, trainer.state["params"], batch_1)
            print(f"train {cfg.name}: the loss alone (chunked "
                  f"cross-entropy, forward and backward, {batch} x {seq} "
                  f"tokens) {ms:.3f} ms, "
                  f"{100 * ms / 1e3 / float(np.median(secs)):.2f}% of the "
                  f"median step ({CARD})", flush=True)
        del trainer, loader, step, batch_1
        return got
    return run


def loss_ms(torch, model, params, batch) -> float:
    """One forward and backward of the train step's loss alone
    (``training.train_loop._ce``: the chunked cross-entropy through the
    model's head), on random bf16 hidden states (seed 0, on the card) of
    the batch's shape, with the gradients of the hidden states and the
    head; host ms up to a synchronize (the step ran it just before, so the
    products are warm)."""
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import _ce
    cfg = model.cfg
    labels = batch["labels"]
    h = normal(torch, (*labels.shape, cfg.d_model), card_generator(torch, 0)
               ).to(torch.bfloat16).requires_grad_(True)
    w = tf.lm_head_block(cfg, params).detach().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(_ce(cfg, h, w, labels), (h, w))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def train_whisper_resume(torch, np, mods, seen: dict, steps: int = 4,
                         more: int = 2, batch: int = 8, seq: int = 448):
    """A hook for ``run_serving``: whisper-tiny at its full config trained
    from the served weights through ``Trainer`` on batches of tokens,
    labels and 1,500 fp32 frames a row (``make_lm_tokens`` and numpy, seed
    1, ``batch`` rows of ``seq`` tokens), checkpointing every 2 steps for
    ``steps`` steps; a fresh ``Trainer`` then resumes from the latest
    checkpoint and runs ``more`` steps, drawing from the same batch
    generator.  Fails unless the resumed state equals the saved one bit
    for bit and the resumed steps' losses equal an uninterrupted run's over
    the same batches.  Returns the launch counts of the two trainers."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.training.trainer import Trainer, TrainerConfig

    def run(model, params):
        cfg = model.cfg
        n = batch * (steps + more + 2)
        toks = make_lm_tokens(n, seq + 1, cfg.vocab_size, seed=1)
        frames = np.random.default_rng(1).normal(
            size=(n, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
        loader = ShardedLoader({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                                "audio_frames": frames}, batch, seed=1,
                               device="cuda")
        tc = TrainConfig(learning_rate=1e-3, schedule="paper_steps",
                         total_steps=steps + more)
        drawn = []

        def batches():
            for b in _forever(loader):
                drawn.append(b)
                yield b
        gen = batches()

        def log(m):
            print(f"train {cfg.name} {m}", flush=True)
        restore = [record_shapes(mods["flash_attention_bwd"],
                                 "flash_attention_bwd",
                                 seen["flash_attention_bwd"], flash_bwd_key),
                   record_shapes(mods["flash_attention"], "flash_attention",
                                 seen["flash_attention"], flash_key)]
        losses, secs = [], []
        with tempfile.TemporaryDirectory() as d:
            _zero(torch, mods)
            t0 = time.perf_counter()
            first = _record_losses(Trainer(
                model, tc, TrainerConfig(ckpt_dir=d, ckpt_every=2,
                                         max_steps=steps, log_every=1),
                log_fn=log, device="cuda", params=params), losses, secs)
            first.fit(gen)
            resumed = _record_losses(Trainer(
                model, tc, TrainerConfig(ckpt_dir=d, ckpt_every=2,
                                         max_steps=steps + more,
                                         log_every=1),
                log_fn=log, device="cuda", params=params), losses, secs)
            if resumed.step != steps or ckpt.latest_step(d) != steps:
                fail(f"train {cfg.name}: resumed at {resumed.step}, want "
                     f"{steps}")
            same = all((a == b) if isinstance(a, int) else torch.equal(a, b)
                       for (_, a), (_, b) in zip(ckpt.leaves(resumed.state),
                                                 ckpt.leaves(first.state)))
            n_leaves = len(list(ckpt.leaves(first.state)))
            if not same:
                fail(f"train {cfg.name}: the restored state differs from "
                     f"the saved one")
            print(f"train {cfg.name}: resumed at step {steps}, the restored "
                  f"state ({n_leaves} leaves) equals the saved one bit for "
                  f"bit", flush=True)
            resumed.fit(gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: m.launches for k, m in mods.items()}
        for r in restore:
            r()
        # uninterrupted, over the batches the two trainers stepped on (the
        # first drew one past its last step and dropped it)
        once_losses = []
        once = _record_losses(Trainer(
            model, tc, TrainerConfig(max_steps=steps + more, log_every=0),
            log_fn=log, device="cuda", params=params), once_losses)
        once.fit(iter(drawn[:steps] + drawn[steps + 1:steps + 1 + more]))
        final_same = all(
            (a == b) if isinstance(a, int) else torch.equal(a, b)
            for (_, a), (_, b) in zip(ckpt.leaves(resumed.state),
                                      ckpt.leaves(once.state)))
        print(f"train {cfg.name}: losses {losses}, uninterrupted "
              f"{once_losses}; final states equal: {final_same}; "
              f"{steps + more} steps with resume in {wall:.3f} s, "
              f"{batch * seq * (steps + more) / wall:.1f} tokens/s; "
              f"launches {got} ({CARD})", flush=True)
        if once_losses[steps] != losses[steps] or \
                not all(np.isfinite(losses)):
            fail(f"train {cfg.name}: step {steps + 1} loss "
                 f"{losses[steps]!r} after resuming, {once_losses[steps]!r} "
                 f"uninterrupted")
        if got["flash_attention_bwd"] != \
                (cfg.encoder_layers + 2 * cfg.num_layers) * (steps + more):
            fail(f"train {cfg.name}: launches {got}")
        del first, resumed, once, loader, drawn
        return got
    return run


# launch names of the port's kernels (csrc/*.cu), and those that the
# profiled passes saw under each (``profile_pass``; the kernels line
# carries them)
KERNEL_PREFIXES = ("margin_head_", "pairwise_sqdist_", "flash_attention_",
                   "fa_bwd_", "ssd_scan_", "ssd_bwd_")
LAUNCH_NAMES = {prefix: set() for prefix in KERNEL_PREFIXES}


# the MoE's routes of the mesh phase (b): the replicate + psum route with
# the expert FFN gathered in the weights' dtype and in int8 and with its
# psum mode, and the token-routing a2a route gathered both ways
MOE_ROUTES = {
    "replicate_gather": dict(moe_route="replicate_psum", moe_ffn_mode="gather",
                             moe_gather_dtype="bf16"),
    "replicate_gather_int8": dict(moe_route="replicate_psum",
                                  moe_ffn_mode="gather",
                                  moe_gather_dtype="int8"),
    "replicate_psum_ffn": dict(moe_route="replicate_psum",
                               moe_ffn_mode="psum", moe_gather_dtype="bf16"),
    "a2a_gather": dict(moe_route="a2a", moe_ffn_mode="gather",
                       moe_gather_dtype="bf16"),
    "a2a_gather_int8": dict(moe_route="a2a", moe_ffn_mode="gather",
                            moe_gather_dtype="int8")}
MOE_TOL = 0.1      # the port's bf16 MoE checks' atol = rtol
EF_BOUND = 0.5 + 127 * 2.0 ** -24   # a residual over its scale


def moe_routes(torch, mesh, secs: dict, tokens=(8, 256)):
    """Mesh phase (b), a hook for ``run_serving`` (dbrx-132b): layer 0's
    routed MoE weights at full width through every sharded route
    (``transformer.moe_sharded(force=True)``: every collective of the
    route over the one-rank NCCL mesh), 8 x 256 random bf16 tokens (seed
    0), capacity factor 8 so no copy drops, each held against the local
    block (``_moe_local``): within atol = rtol = ``MOE_TOL``, 50 times
    that for int8."""
    from repro_torch.models import transformer as T

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg.replace(moe_capacity_factor=8.0)
        p = {k: params[f"blocks.mlp.{k}"][0]
             for k in ("router", "w_gate", "w_up", "w_down")}
        g = torch.Generator().manual_seed(0)
        x = torch.randn(*tokens, cfg.d_model, generator=g).to(
            "cuda", torch.bfloat16)
        with torch.no_grad():
            want = T._moe_local(cfg, p, x.reshape(-1, cfg.d_model)) \
                .reshape(x.shape).float()
            for name, kw in MOE_ROUTES.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = T.moe_sharded(cfg.replace(**kw), p, x, mesh,
                                    force=True).float()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                tol = MOE_TOL * (50 if kw["moe_gather_dtype"] == "int8"
                                 else 1)
                err = (got - want).abs()
                worst = float((err - tol * want.abs()).max())
                print(f"mesh moe {name} at {tuple(x.shape)} tokens, "
                      f"d_model {cfg.d_model}, {cfg.num_experts} experts top "
                      f"{cfg.experts_per_token}, d_ff {cfg.d_ff}: max abs "
                      f"err {float(err.max()):.6g} against the local "
                      f"block, {ms:.2f} ms ({CARD})", flush=True)
                if not torch.isfinite(got).all() or worst > tol:
                    fail(f"mesh moe {name}: error {float(err.max())} "
                         f"beyond atol = rtol = {tol}")
                del got, err
        del x, want, p
        secs["b"] = time.perf_counter() - t0
    return run


def compressed_dp(torch, np, mods, mesh, seen: dict, secs: dict,
                  launches: dict, steps: int = 2, batch: int = 8,
                  seq: int = 2048, lr: float = 1e-4):
    """Mesh phase (c), a hook for ``run_serving`` (qwen2-1.5b at its full
    config, before its training): from the served weights, one plain train
    step (``train_loop.make_train_step``) and then ``steps`` steps of
    ``grad_compression="int8_ef"`` (``compressed_dp``'s step over the
    one-rank NCCL mesh's "data" axis) on the same batch of ``batch`` x
    ``seq`` tokens (``make_lm_tokens`` seed 1): step 1's loss must meet the
    plain step's within 1e-3 relative (the loss precedes the update), and
    every residual the quantizer leaves be within half its scale (and the
    fp32 rounding of q * scale).  Prints the peak device memory."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.distributed import compression
    from repro_torch.training.compressed_dp import (
        init_ef_state, make_compressed_dp_train_step)
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        toks = torch.as_tensor(make_lm_tokens(batch, seq + 1,
                                              cfg.vocab_size, seed=1),
                               device="cuda")
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        tc = TrainConfig(learning_rate=lr, schedule="paper_steps",
                         total_steps=steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, m = make_train_step(model, tc)(init_train_state(model, tc,
                                                           params), b)
        plain = float(m["loss"])
        plain_peak = torch.cuda.max_memory_allocated()
        del m
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        quantize, ratios = compression.quantize_ef, []

        def recording(g, residual):
            q, scale, left = quantize(g, residual)
            ratios.append(torch.amax(torch.abs(left)) / scale)
            return q, scale, left

        compression.quantize_ef = recording
        restore = [record_shapes(mods["flash_attention_bwd"],
                                 "flash_attention_bwd",
                                 seen["flash_attention_bwd"], flash_bwd_key),
                   record_shapes(mods["flash_attention"], "flash_attention",
                                 seen["flash_attention"], flash_key)]
        try:
            step = make_compressed_dp_train_step(
                model, dataclasses.replace(tc, grad_compression="int8_ef"),
                mesh, "data")
            carry = (init_train_state(model, tc, params),
                     init_ef_state(params))
            _zero(torch, mods)
            losses, walls = [], []
            for _ in range(steps):
                t1 = time.perf_counter()
                carry, m = step(carry, b)
                losses.append(float(m["loss"]))
                walls.append(time.perf_counter() - t1)
            got = {k: mod.launches for k, mod in mods.items()}
        finally:
            compression.quantize_ef = quantize
            for r in restore:
                r()
        worst = float(torch.stack(ratios).max())
        peak = torch.cuda.max_memory_allocated()
        print(f"mesh compressed DP {cfg.name} (int8_ef over a one-rank "
              f"NCCL data axis, {len(ratios) // steps} leaves): losses "
              f"{losses}, plain step 1 loss {plain!r}, step seconds "
              f"{[round(w, 3) for w in walls]}, worst residual / scale "
              f"{worst:.7f}, max_memory_allocated bytes {peak} (plain step "
              f"{plain_peak}), launches {got} ({CARD})", flush=True)
        if not all(np.isfinite(losses)) or \
                abs(losses[0] - plain) > 1e-3 * abs(plain):
            fail(f"compressed DP: step 1 loss {losses[0]} against the plain "
                 f"step's {plain}")
        if worst > EF_BOUND:
            fail(f"compressed DP: a residual reached {worst} of its scale")
        if got["flash_attention_bwd"] == 0:
            fail("compressed DP never launched the attention backward")
        launches["compressed_dp"] = got
        del carry, step, b, toks, ratios
        gc.collect()
        torch.cuda.empty_cache()
        secs["c"] = time.perf_counter() - t0
    return run


def check_halo(torch, mods, mesh, secs: dict, launches: dict,
               seen: dict, B=8, T=2048, H=8, Hk=4, hd=256, window=1024):
    """Mesh phase (d): ``halo_window_attention`` on the one-rank NCCL
    mesh's "model" axis at gemma3-4b's local-layer shape (B 8, T 2,048, H
    8 over 4 kv heads, hd 256, window 1,024; fp32, seed 0) against the
    port's windowed ``blockwise_attention``: within 2e-5, the reference's
    halo tolerance.  It must run the ``flash_attention`` kernel (once, in
    the halo's frame: ``q_offset`` = ``kv_start`` = window on rank 0; its
    launches go to ``launches["halo"]``); the call's seconds to a device
    synchronize (the median of 5, after one) are printed beside the
    windowed blockwise attention's."""
    from repro_torch.models.layers import blockwise_attention
    from repro_torch.serving.halo_attention import halo_window_attention
    fa = mods["flash_attention"]
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, T, H, hd, generator=g).cuda()
    k, v = (torch.randn(B, T, Hk, hd, generator=g).cuda() for _ in "kv")

    def halo():
        return halo_window_attention(q, k, v, window=window, mesh=mesh,
                                     axis="model")

    def plain():
        return blockwise_attention(q, k, v, causal=True, window=window,
                                   kv_chunk=1024)

    def wall_ms(fn):
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(walls)
    with torch.no_grad():
        restore = record_shapes(fa, "flash_attention", seen["flash_attention"],
                                flash_key)
        _zero(torch, mods)
        got = halo()
        torch.cuda.synchronize()
        launches["halo"] = {k: m.launches for k, m in mods.items()}
        restore()
        err = float((got - plain()).abs().max())
        ms, plain_ms = wall_ms(halo), wall_ms(plain)
    print(f"mesh halo attention at (B {B}, T {T}, H {H}/{Hk}, hd {hd}, "
          f"window {window}): max abs err {err:.3g} against the windowed "
          f"blockwise attention; {ms:.3f} ms on the kernel, the blockwise "
          f"attention {plain_ms:.3f} ms; launches {launches['halo']} "
          f"({CARD})", flush=True)
    if not err <= 2e-5:
        fail(f"halo attention: error {err} > 2e-5")
    if launches["halo"]["flash_attention"] != 1:
        fail(f"halo attention launched flash_attention "
             f"{launches['halo']['flash_attention']} times, want 1")
    del q, k, v, got
    torch.cuda.empty_cache()
    secs["d"] = time.perf_counter() - t0


def _hooks(*fns):
    """One ``run_serving`` hook that calls each of ``fns`` in turn."""
    def run(model, params):
        for fn in fns:
            fn(model, params)
    return run


def _sharded_batch_pspecs(mesh, batch):
    """Each batch leaf's rows over "data", kept though the axis has one
    rank, so the step takes the batch axis's collectives too."""
    from repro_torch.distributed import sharding as shd
    return {k: shd.P("data", *(None,) * (v.ndim - 1)) for k, v in batch.items()}


# the shape key ``record_shapes`` takes for each kernel's wrapper
SHAPE_KEYS = {"margin_head": margin_key, "flash_attention": flash_key,
              "flash_attention_bwd": flash_bwd_key, "ssd_scan": ssd_key,
              "ssd_scan_bwd": ssd_bwd_key}
ATTENTION = ("flash_attention", "flash_attention_bwd")


def sharded_train(torch, np, mods, mesh, seen: dict, secs: dict,
                  launches: dict, steps: int = 4, batch: int = 8,
                  seq: int = 2048, lr: float = 1e-4,
                  kernels=ATTENTION, part: str = "a",
                  path: str = "sharded_train", seen_split=None,
                  split_part: str = "f"):
    """Sharded phase (a), a hook for ``run_serving`` (qwen2-1.5b at its
    full config; phase (d) with ``kernels`` the SSD scan's pair, mamba2-1.3b,
    whose Mamba2 mixers compute on their heads' block over "model"):
    ``steps`` plain train steps from the served weights,
    then ``steps`` of ``make_sharded_train_step`` under ``fsdp_tp`` and
    again under ``tp`` over the one-rank NCCL mesh (``force``: each weight's storage dims gathered
    over "data" in the layer's recomputed body, its tensor-parallel dims
    over "model" computed as blocks and summed over the axis, every
    gradient reduced over the axes its leaf is whole on), both on one
    batch of ``batch`` x ``seq`` tokens (``make_lm_tokens`` seed 2): step
    1's loss must equal the plain step's to the bit (the loss precedes
    the update), and the sharded steps launch each of ``kernels`` (the
    attention kernel and its backward by default).  Prints each step's
    seconds and tokens/s, each run's peak memory, and each policy's step
    time over the plain one's (``tp`` gathers nothing over "data": what is
    left of ``fsdp_tp``'s gap is its storage gathers).  The launches go to
    ``launches[path]``, the seconds to ``secs[part]``.

    With ``seen_split`` (a dict of shape sets; phase (f), qwen2-1.5b; and
    in phase (d), mamba2-1.3b), four more steps under ``fsdp_tp_seq``: the
    sequence split over "model" (one block at offset 0 on the forced rank:
    K and V gathered over the axis, attention at ``q_offset``; a Mamba2
    mixer's conv halo gathered, its scan from zero, no state to exchange;
    the loss's share summed over it), every weight gathered as storage;
    step 1's loss must be the plain step's to the bit and the steps must
    launch each of ``kernels``, counted apart (``launches[path +
    "_seq"]``, seconds ``secs[split_part]``)."""
    policies = ("fsdp_tp", "tp")
    split = ("fsdp_tp_seq",) if seen_split is not None else ()
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_sharded_train_step,
                                                 make_train_step)

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        toks = torch.as_tensor(make_lm_tokens(batch, seq + 1,
                                              cfg.vocab_size, seed=2),
                               device="cuda")
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        tc = TrainConfig(learning_rate=lr, schedule="paper_steps",
                         total_steps=steps)
        out = {}
        for name in ("plain",) + policies + split:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if name == "plain":
                step = make_train_step(model, tc)
                state = init_train_state(model, tc, params)
            else:
                step, _, sh = make_sharded_train_step(
                    model, tc, mesh, name, _sharded_batch_pspecs(mesh, b),
                    force=True)
                state = shd.shard_tree(init_train_state(model, tc, params),
                                       sh)
                mine = seen_split if name in split else seen
                restore = [record_shapes(mods[k], k, mine[k], SHAPE_KEYS[k])
                           for k in kernels]
                if name in (policies[0],) + split:
                    if name in split:
                        t_split = time.perf_counter()
                    _zero(torch, mods)
            losses, walls = [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                walls.append(time.perf_counter() - t1)
            if name != "plain":
                for r in restore:
                    r()
            if name == policies[-1]:
                got = {k: mod.launches for k, mod in mods.items()}
            if name in split:
                got_split = {k: mod.launches for k, mod in mods.items()}
                secs[split_part] = time.perf_counter() - t_split
            out[name] = (losses, walls, torch.cuda.max_memory_allocated())
            del state, step, m
        for name, (losses, walls, peak) in out.items():
            print(f"sharded train {cfg.name} {name}: losses {losses}, step "
                  f"seconds {walls}, tokens/s "
                  f"{[round(batch * seq / w, 1) for w in walls]}, "
                  f"max_memory_allocated bytes {peak} ({CARD})", flush=True)
        print(f"sharded train {cfg.name}: launches {got} ({CARD})",
              flush=True)
        if split:
            print(f"sharded train {cfg.name} {split[0]}: launches "
                  f"{got_split} ({CARD})", flush=True)
        # the medians after the first step, which pays the groups' first
        # collectives
        p_w = float(np.median(out["plain"][1][1:]))
        plain = out["plain"][0][0]
        for policy in policies + split:
            s_w = float(np.median(out[policy][1][1:]))
            print(f"sharded train {cfg.name}: {policy} over plain step "
                  f"seconds {s_w / p_w:.4f} (medians of steps 2-{steps}, "
                  f"{s_w:.4f} and {p_w:.4f}); tokens/s {policy} "
                  f"{batch * seq / s_w:.1f}, plain {batch * seq / p_w:.1f} "
                  f"({CARD})", flush=True)
            sharded = out[policy][0][0]
            if not all(np.isfinite(out[policy][0])) or sharded != plain:
                fail(f"sharded train {policy}: step 1 loss {sharded} is not "
                     f"the plain step's {plain} to the bit")
        for k in kernels:
            if got[k] == 0:
                fail(f"sharded train {cfg.name} never launched {k}")
            if split and got_split[k] == 0:
                fail(f"sharded train {cfg.name} {split[0]} never launched "
                     f"{k}")
        launches[path] = got
        if split:
            launches[path + "_seq"] = got_split
        del b, toks, out
        gc.collect()
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0 - (secs[split_part] if split
                                                 else 0)
    return run


def seq_prefill(torch, np, mods, mesh, seen: dict, secs: dict,
                launches: dict, batch: int = 8, prompt: int = 512,
                kernels=("flash_attention",), part: str = "g",
                path: str = "sharded_prefill_seq"):
    """Sharded phase (g), a hook for ``run_serving`` (zamba2-2.7b and
    whisper-tiny at their full configs): the served weights behind
    ``ServeEngine(mesh=, policy="fsdp_tp_seq", force=True)`` on the
    one-rank NCCL mesh (the sequence split over "model": one block at
    offset 0, K and V gathered along the axis, a Mamba2 layer's conv halo
    gathered; whisper's 1,500 frames split too) and behind the unmeshed
    engine: ``prefill`` of ``batch`` prompts of ``prompt`` random tokens
    (seed 5; whisper's 1,500 frames a request).  The meshed prefill's
    last-position logits and every cache leaf must meet the unmeshed
    ones' within 2^-7 relative plus 1e-3 of the largest (bit-equality is
    printed), and the meshed prefill must launch each of ``kernels``.
    The launches go to ``launches[path]``, the seconds to
    ``secs[part]``."""
    from repro_torch.serving.engine import ServeEngine

    def flat(tree, pre=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from flat(tree[k], pre + k + ".")
            else:
                yield pre + k, tree[k]

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        rng = np.random.default_rng(5)
        req = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt))}
        if cfg.family == "audio":
            req["audio_frames"] = rng.normal(
                size=(batch, cfg.encoder_tokens, cfg.d_model)).astype(
                np.float32)
        out = {}
        for name, kw in (("unmeshed", {}),
                         ("meshed", dict(mesh=mesh, policy="fsdp_tp_seq",
                                         force=True))):
            eng = ServeEngine(model, params, prompt + 8, batch,
                              device="cuda", **kw)
            if name == "meshed":
                restore = [record_shapes(mods[k], k, seen[k], SHAPE_KEYS[k])
                           for k in kernels]
                _zero(torch, mods)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache, _ = eng.prefill(req)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            if name == "meshed":
                got = {k: m.launches for k, m in mods.items()}
                for r in restore:
                    r()
            out[name] = (logits, dict(flat(cache)), wall)
            eng.close()
            del eng
        (ml, mc, mw), (ul, uc, uw) = out["meshed"], out["unmeshed"]
        errs, bits = {}, True
        for k, (a, b) in [("logits", (ml, ul))] + [
                (k, (mc[k], uc[k])) for k in uc]:
            a, b = a.float(), b.float()
            d = (a - b).abs()
            errs[k] = float(d.max())
            bits &= bool(torch.equal(a, b))
            if a.shape != b.shape or not bool(
                    (d <= 1e-3 * b.abs().max() + 2 ** -7 * b.abs()).all()):
                fail(f"sharded prefill {cfg.name} fsdp_tp_seq: {k} max err "
                     f"{errs[k]} against the unmeshed engine")
        for k in kernels:
            if got[k] == 0:
                fail(f"sharded prefill {cfg.name} fsdp_tp_seq never "
                     f"launched {k}")
        print(f"sharded prefill {cfg.name} fsdp_tp_seq: {batch} x {prompt} "
              f"tokens, seconds meshed {mw:.3f} unmeshed {uw:.3f}; logits "
              f"and caches against the unmeshed engine: max abs err "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f"; bit-equal {bits}; launches {got} ({CARD})", flush=True)
        launches[path] = got
        del out, ml, mc, ul, uc
        gc.collect()
        torch.cuda.empty_cache()
        secs[part] = secs.get(part, 0.0) + time.perf_counter() - t0
    return run


def sharded_serve(torch, np, mods, mesh, seen: dict, secs: dict,
                  launches: dict, rows: int = 64, batch: int = 8,
                  prompt: int = 128, gen: int = 16,
                  kernels=("margin_head", "flash_attention"),
                  part: str = "c", path: str = "sharded_serve"):
    """Sharded phase (c), a hook for ``run_serving`` (qwen2-1.5b at its
    full config; phase (e) with ``kernels`` holding the SSD scan,
    mamba2-1.3b and zamba2-2.7b, whose Mamba2 mixers compute on their
    heads' block and whose state caches hold it, the shared attention's
    cache split as qwen2's): the served weights behind ``ServeEngine(mesh=,
    policy="tp", force=True)`` on the one-rank NCCL mesh (stored as
    DTensors, each layer computing on its blocks over "model" and summing
    over the axis, the rows over "data", the cache's positions split over
    "model" and decoded by flash-decode, the stats and logits gathered
    back) and behind the unmeshed engine: ``score`` on ``rows`` rows of
    ``prompt`` tokens, a ``score_pool`` top-10 over them in pages of 16,
    and ``generate`` for ``batch`` prompts, ``gen`` steps (random tokens,
    seed 3).  The meshed
    engine's stats must meet the unmeshed ones' at the pool pass's
    tolerance (atol = rtol = 5e-5 on margin and max log-prob, 5e-4 on
    entropy), its top1, top-k and tokens exactly; ``margin_head`` must
    run in the meshed passes, and each of ``kernels``.  ``score`` runs
    twice, the first paying the engine's thread groups' first
    collectives.  Prints each pass's seconds and the meshed over the
    unmeshed, ``generate``'s tokens/s and whether ``score``'s stats are
    the unmeshed ones to the bit.  The launches go to ``launches[path]``,
    the seconds to ``secs[part]``."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.sweep import TopKSink

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        rng = np.random.default_rng(3)
        pool = {"tokens": rng.integers(0, cfg.vocab_size, (rows, prompt))}
        req = {"tokens": pool["tokens"][:batch]}
        out = {}
        for name, kw in (("unmeshed", {}),
                         ("meshed", dict(mesh=mesh, policy="tp",
                                         force=True))):
            eng = ServeEngine(model, params, prompt + gen + 8, batch,
                              device="cuda", **kw)
            if name == "meshed":
                restore = [record_shapes(mods[k], k, seen[k], SHAPE_KEYS[k])
                           for k in kernels]
                _zero(torch, mods)
            res, walls = {}, {}
            # the first score pays the groups' first collectives
            for label, fn in (
                    ("score", lambda: eng.score(pool)),
                    ("score again", lambda: eng.score(pool)),
                    ("score_pool", lambda: eng.score_pool(
                        pool, page_rows=16, sink=TopKSink(10))),
                    ("generate", lambda: eng.generate(req, gen))):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res[label] = fn()
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t1
            if name == "meshed":
                got = {k: m.launches for k, m in mods.items()}
                for r in restore:
                    r()
            eng.close()
            out[name] = (res, walls)
            del eng
        for name, (_, walls) in out.items():
            print(f"sharded serve {cfg.name} {name}: seconds "
                  + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
                  + f" ({rows} rows of {prompt} tokens; generate {batch} x "
                  f"{gen}; {CARD})", flush=True)
        (_, mw), (_, uw) = out["meshed"], out["unmeshed"]
        print(f"sharded serve {cfg.name}: meshed over unmeshed seconds: "
              + ", ".join(f"{k} {mw[k] / uw[k]:.4f}" for k in mw)
              + f"; generate tokens/s meshed "
              f"{batch * gen / mw['generate']:.1f}, unmeshed "
              f"{batch * gen / uw['generate']:.1f} (prefill "
              f"included; {CARD})", flush=True)
        print(f"sharded serve {cfg.name}: launches {got} ({CARD})",
              flush=True)
        a, b = out["meshed"][0], out["unmeshed"][0]
        for k, tol in (("margin", 5e-5), ("entropy", 5e-4),
                       ("max_logprob", 5e-5)):
            g, w = getattr(a["score"], k), getattr(b["score"], k)
            err = float((g - w).abs().max())
            if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
                fail(f"sharded serve score {k}: max err {err} beyond "
                     f"atol = rtol = {tol}")
        if not torch.equal(a["score"].top1, b["score"].top1) or not all(
                torch.equal(x, y) for x, y in zip(a["score again"],
                                                  a["score"])):
            fail("sharded serve score: top1 differs from the unmeshed, or "
                 "a second score from the first")
        if not np.array_equal(a["score_pool"], b["score_pool"]):
            fail(f"sharded serve score_pool top-k {a['score_pool']} against "
                 f"{b['score_pool']}")
        if not torch.equal(a["generate"], b["generate"]):
            fail("sharded serve generate: tokens differ from the unmeshed")
        for k in ("margin_head",) + tuple(kernels):
            if got[k] == 0:
                fail(f"sharded serve {cfg.name} never launched {k}")
        bits = all(torch.equal(x, y) for x, y in zip(a["score"], b["score"]))
        print(f"sharded serve {cfg.name}: score, score_pool and generate "
              f"agree with the unmeshed engine; score stats bit-equal "
              f"{bits}", flush=True)
        launches[path] = got
        del out, a, b
        gc.collect()
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
    return run


def sharded_trainer(torch, np, mods, mesh, seen: dict, secs: dict,
                    launches: dict, steps: int = 4, batch: int = 8,
                    seq: int = 448):
    """Sharded phase (b), a hook for ``run_serving`` (whisper-tiny at its
    full config): ``Trainer(mesh=, policy="fsdp_tp", batch_pspecs=,
    force=True)`` over batches from ``ShardedLoader(mesh=)`` (tokens,
    labels and 1,500 fp32 frames a row, seed 4) for ``steps`` steps,
    checkpointing every 2; a second run stops at step 2, and a fresh
    ``Trainer`` resumes from its checkpoint (``restore(shardings=)``) and
    runs the last steps on the same batches.  Fails unless the resumed
    run's state equals the uninterrupted run's bit for bit."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.training.trainer import Trainer, TrainerConfig

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        n = batch * steps
        toks = make_lm_tokens(n, seq + 1, cfg.vocab_size, seed=4)
        frames = np.random.default_rng(4).normal(
            size=(n, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
        loader = ShardedLoader({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                                "audio_frames": frames}, batch, mesh=mesh,
                               seed=4, device="cuda")
        batches = list(loader.epoch())
        bp = _sharded_batch_pspecs(mesh, batches[0])
        tc = TrainConfig(learning_rate=1e-3, schedule="paper_steps",
                         total_steps=steps)
        restore = [record_shapes(mods[k], k, seen[k], key)
                   for k, key in (("flash_attention", flash_key),
                                  ("flash_attention_bwd", flash_bwd_key))]
        _zero(torch, mods)
        walls = {}
        with tempfile.TemporaryDirectory() as d:
            def trainer(sub, max_steps):
                return Trainer(model, tc, TrainerConfig(
                    ckpt_dir=str(Path(d) / sub), ckpt_every=2, log_every=0,
                    max_steps=max_steps), mesh=mesh, policy="fsdp_tp",
                    batch_pspecs=bp, device="cuda", params=params,
                    force=True, log_fn=lambda m: None)
            t1 = time.perf_counter()
            full = trainer("full", steps)
            full.fit(batches)
            torch.cuda.synchronize()
            walls["uninterrupted"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            cut = trainer("cut", 2)
            cut.fit(batches[:2])
            del cut
            resumed = trainer("cut", steps)
            if resumed.step != 2:
                fail(f"sharded trainer resumed at step {resumed.step}, "
                     f"want 2")
            resumed.fit(batches[2:])
            torch.cuda.synchronize()
            walls["stopped and resumed"] = time.perf_counter() - t1
        got = {k: m.launches for k, m in mods.items()}
        for r in restore:
            r()
        a, b = shd.full_tree(full.state), shd.full_tree(resumed.state)
        same = a["step"] == b["step"] == steps and all(
            torch.equal(a["params"][k], b["params"][k]) for k in a["params"]
        ) and all(torch.equal(x[s], y[s]) for x, y in zip(a["opt"], b["opt"])
                  for s in x)
        placed = all(shd.is_placed(v) for v in resumed.state["params"]
                     .values())
        print(f"sharded trainer {cfg.name}: {steps} steps uninterrupted and "
              f"stopped at 2 then resumed: seconds " + ", ".join(
                  f"{k} {v:.3f}" for k, v in walls.items())
              + f"; resumed state bit-equal {same}, placed {placed}; "
              f"launches {got} ({CARD})", flush=True)
        if not same or not placed:
            fail("sharded trainer: the resumed run's state is not the "
                 "uninterrupted run's")
        if got["flash_attention_bwd"] == 0:
            fail("sharded trainer never launched the attention backward")
        launches["sharded_trainer"] = got
        del full, resumed, a, b, batches, loader
        gc.collect()
        torch.cuda.empty_cache()
        secs["b"] = time.perf_counter() - t0
    return run


def visible_pairs(Tq: int, Tk: int, causal: bool, window: int,
                  q_offset: int = 0, kv_start: int = 0) -> int:
    """The (query, key) pairs a mask leaves visible, query row i at
    position q_offset + i and keys from kv_start: the True entries of
    ``sdpa_mask``."""
    import numpy as np
    q = q_offset + np.arange(Tq)
    hi = np.minimum(q, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(q - window + 1, kv_start) if window > 0 \
        else np.full(Tq, kv_start)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(case) -> float:
    """One ``flash_attention`` call's operations at (B, H, Hk, Tq, Tk, hd,
    causal, window[, q_offset, kv_start]), as the bound column counts
    them: 4 hd a visible pair (QK^T and PV)."""
    B, H, Hk, Tq, Tk, hd = case[:6]
    return 4.0 * hd * B * H * visible_pairs(Tq, Tk, **mask_of(case))


def ssd_flops(case) -> float:
    """One ``ssd_scan`` call's operations at (B, T, H, hd, N, C), as the
    bound column counts them: C.B^T per (batch, chunk); per (batch, chunk,
    head) the lower-triangle intra term (C (C+1)/2 hd FMAs), the chunk
    summary and the inter term (C hd N FMAs each)."""
    B, T, H, hd, N, C = case
    C = min(C, T)
    nc = -(-T // C)
    return float(B * nc * (2 * C * C * N + H * (C * (C + 1) * hd
                                                  + 4 * C * hd * N)))


# the kernels' own operations by call key; a backward 2.5 times its forward
# (five products against two)
KERNEL_FLOPS = {"flash_attention": (flash_key, attention_flops),
                "flash_attention_bwd": (flash_bwd_key,
                                        lambda c: 2.5 * attention_flops(c)),
                "ssd_scan": (ssd_key, ssd_flops),
                "ssd_scan_bwd": (ssd_bwd_key, lambda c: 2.5 * ssd_flops(c))}
FLOPS_TOL = 0.2    # tests/test_roofline.py:36-48, the reference's 20%


def count_flops(torch, mods, fn):
    """``fn()`` under ``FlopCounterMode`` with the launch counts zeroed just
    before and read just after.  The counter sees aten ops only; each
    hand-written kernel launch (a ctypes call) is kept a call at a time,
    as ``record_shapes`` keeps shapes, and added at its own operations
    (``KERNEL_FLOPS``).  Returns (aten flops, kernel flops, launches)."""
    from torch.utils.flop_counter import FlopCounterMode
    calls = {k: [] for k in KERNEL_FLOPS}
    restore = [record_shapes(mods[k], k, calls[k], key)
               for k, (key, _) in KERNEL_FLOPS.items()]
    _zero(torch, mods)
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
            torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    got = {k: m.launches for k, m in mods.items()}
    kern = sum(KERNEL_FLOPS[k][1](c) for k, cs in calls.items() for c in cs)
    return float(fc.get_total_flops()), kern, got


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def _lm_batch(torch, cfg, batch: int, seq: int):
    """``batch`` rows of ``seq`` tokens and their next tokens
    (``make_lm_tokens``, seed 0), on the card."""
    from repro_torch.data.synth import make_lm_tokens
    toks = torch.as_tensor(make_lm_tokens(batch, seq + 1, cfg.vocab_size,
                                          seed=0), device="cuda")
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def launch_tools_forward(torch, mods, secs: dict, launches: dict,
                         batch: int = 8, seq: int = 2048):
    """A hook for ``run_serving`` (phase ``launch_tools`` (a), mamba2-1.3b
    and zamba2-2.7b): one forward of ``batch`` x ``seq`` tokens counted by
    ``count_flops`` against the twin roofline's ``forward_flops``; the
    ratio is printed only (the SSD formula, ``roofline.py:143-152``, is
    approximate, and the reference holds only dense formulas).  Fails
    unless each kernel launched as often as a served forward launches it."""
    from repro_torch.launch.roofline import forward_flops

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        data = _lm_batch(torch, cfg, batch, seq)
        with torch.no_grad():
            aten, kern, got = count_flops(
                torch, mods, lambda: model.forward(params, data))
        want = forward_flops(cfg, batch * seq, (seq + 1) / 2)
        print(f"launch_tools {cfg.name} forward {batch} x {seq}: counted "
              f"{aten + kern:.6e} flops ({aten:.6e} aten, {kern:.6e} "
              f"kernels), analytic {want:.6e}, counted/analytic "
              f"{(aten + kern) / want:.4f} (printed only); launches {got}",
              flush=True)
        for k, n in per_forward(cfg).items():
            if got[k] != n:
                fail(f"launch_tools {cfg.name} forward: {k} launched "
                     f"{got[k]} times, want {n}")
        _add(launches, got)
        secs["a " + cfg.name] = time.perf_counter() - t0
    return run


def launch_tools_train(torch, mods, secs: dict, launches: dict,
                       step_secs: list, batch: int = 8, seq: int = 2048):
    """Phase ``launch_tools`` (a) for qwen2-1.5b, a hook run after its
    training (``train_lm``, whose step seconds are in ``step_secs``): one
    forward and one more training step at the training phase's shape
    (``batch`` x ``seq`` tokens, ``remat="layer"``, ``logits_chunk``
    16,384) counted by ``count_flops``.  The forward must come within 20%
    of the twin roofline's ``forward_flops(cfg, B T, (T + 1) / 2)``, the
    step within 20% of ``forward_flops * (3 + 1) + 2 B T D V * 3`` (the
    reference's train cell with remat).  Prints ``model_flops = 6 (body +
    head) B T`` and the roofline-implied ``mfu`` of the measured steps:
    model_flops / (median of steps 2-6 x 989 TFLOP/s)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.roofline import (PEAK_FLOPS, forward_flops,
                                             param_counts)
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    def check(label, aten, kern, want, got):
        ratio = (aten + kern) / want
        print(f"launch_tools {label}: counted {aten + kern:.6e} flops "
              f"({aten:.6e} aten, {kern:.6e} kernels), analytic "
              f"{want:.6e}, counted/analytic {ratio:.4f}; launches {got}",
              flush=True)
        if abs(ratio - 1) > FLOPS_TOL:
            fail(f"launch_tools {label}: counted/analytic {ratio:.4f}, "
                 f"outside 1 +- {FLOPS_TOL}")
        _add(launches, got)

    def run(model, params):
        t0 = time.perf_counter()
        cfg = model.cfg
        B, T, D, V = batch, seq, cfg.d_model, cfg.vocab_size
        data = _lm_batch(torch, cfg, B, T)
        fwd = forward_flops(cfg, B * T, (T + 1) / 2)
        with torch.no_grad():
            aten, kern, got = count_flops(
                torch, mods, lambda: model.forward(params, data))
        check(f"{cfg.name} forward {B} x {T}", aten, kern, fwd, got)
        if got["flash_attention"] != cfg.num_layers:
            fail(f"launch_tools {cfg.name} forward: launches {got}")
        tc = TrainConfig(learning_rate=1e-4, schedule="paper_steps",
                         total_steps=6)
        step = make_train_step(model, tc)
        state = init_train_state(model, tc, params)
        aten, kern, got = count_flops(torch, mods,
                                      lambda: step(state, data))
        check(f"{cfg.name} train step {B} x {T} (remat {cfg.remat}, "
              f"logits_chunk {cfg.logits_chunk})", aten, kern,
              fwd * (3 + 1) + 2.0 * B * T * D * V * 3, got)
        if got["flash_attention_bwd"] != cfg.num_layers or \
                got["flash_attention"] < cfg.num_layers:
            fail(f"launch_tools {cfg.name} train step: launches {got}")
        del state, step
        pc = param_counts(cfg)
        model_flops = 6.0 * (pc.body_active + pc.head) * B * T
        med = statistics.median(step_secs[1:])
        print(f"launch_tools {cfg.name} model_flops {model_flops:.6e} a "
              f"step ({model_flops / (B * T):.6e} a token); median step "
              f"{med:.4f} s (steps 2-{len(step_secs)}); roofline-implied "
              f"mfu {model_flops / (med * PEAK_FLOPS):.4f} at "
              f"{PEAK_FLOPS:.3g} FLOP/s ({CARD})", flush=True)
        secs["a " + cfg.name] = time.perf_counter() - t0
    return run


def _then(first, second):
    """A ``run_serving`` hook that runs ``first`` (whose result it
    returns), then ``second``."""
    def run(model, params):
        out = first(model, params)
        second(model, params)
        return out
    return run


DRYRUN_CELL = ("qwen2-1.5b", "train_4k", "single")
DRYRUN_DECODE_CELL = ("qwen1.5-4b", "decode_32k", "single")
DRYRUN_TIMEOUT_S = 150


def _dryrun_child(cell) -> dict:
    """``python -m repro_torch.launch.dryrun`` on one (arch, shape, mesh)
    cell in a child process (at most ``DRYRUN_TIMEOUT_S`` s): its record,
    printed with the child's seconds."""
    arch, shape, mesh = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           timeout=DRYRUN_TIMEOUT_S,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    except subprocess.TimeoutExpired:
        fail(f"launch_tools dry-run {cell}: over {DRYRUN_TIMEOUT_S} s")
    if r.returncode != 0:
        fail(f"launch_tools dry-run {cell}: exit {r.returncode}\n"
             f"{r.stderr[-3000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"launch_tools dry-run record {cell} "
          f"({time.perf_counter() - t0:.1f} s, a fake trace on the host): "
          f"{json.dumps(rec)}", flush=True)
    return rec


def launch_tools_fits_and_dryrun(torch, secs: dict):
    """Phase ``launch_tools`` (b) and (c).  (b) the fits-proof on the card:
    for each mesh kind, how many (arch x cell) rows fit at 0.9 of the
    card's memory (``fitsproof.capacity``) and how many at 0.9 of the
    reference's 16 GB, each at the grad accumulation the dry-run picks.
    (c) the dry-run (``_dryrun_child``) on ``DRYRUN_CELL``: its FLOPs a
    device against the analytic count of the tensor-parallel design
    (``dryrun.expected_train_flops``) and the twin roofline's
    ``flops_local``; fails outside the count +- 20%, if it did not gather,
    or if its peak of temporaries does not fit the card.  Then on
    ``DRYRUN_DECODE_CELL`` (a decode step against a 32k cache, split
    along the sequence over "model"): fails if its arguments and
    temporaries peak over 0.9 of the card's memory."""
    from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, cells,
                                     get_config)
    from repro_torch.launch import fitsproof
    from repro_torch.launch.dryrun import (expected_train_flops,
                                           pick_grad_accum)
    from repro_torch.launch.roofline import analyze_cell, mesh_sizes
    t0 = time.perf_counter()
    hbm = fitsproof.capacity("cuda")
    rows = [(a, s) for a in ARCH_IDS for s in cells(a)]
    for mesh in ("single", "multi"):
        card = tpu = 0
        for arch, shape in rows:
            cfg = get_config(arch)
            r = fitsproof.residents(
                cfg, shape, mesh, pick_grad_accum(cfg, shape,
                                                  mesh_sizes(mesh)), hbm=hbm)
            card += r["fits"]
            tpu += r["total"] <= 0.9 * 16e9
        print(f"launch_tools fits ({mesh} mesh): {card} of {len(rows)} "
              f"(arch x cell) rows at 0.9 x {hbm:.0f} B (read from the "
              f"card), {tpu} at 0.9 x 16e9 B (the reference's chip) "
              f"({CARD})", flush=True)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch, shape, mesh = DRYRUN_CELL
    rec = _dryrun_child(DRYRUN_CELL)
    cfg = get_config(arch)
    want = analyze_cell(cfg, SHAPES_BY_NAME[shape], mesh, rec["grad_accum"])
    split = expected_train_flops(cfg, SHAPES_BY_NAME[shape],
                                 mesh_sizes(mesh))
    print(f"launch_tools dry-run flops a device {rec['flops']:.6e}: "
          f"{rec['flops'] / split:.4f} of the split's analytic "
          f"{split:.6e}, {rec['flops'] / want.flops_local:.4f} x the "
          f"roofline's flops_local {want.flops_local:.6e} (the analytic "
          f"{split / want.flops_local:.4f} x)", flush=True)
    if abs(rec["flops"] / split - 1) > FLOPS_TOL:
        fail(f"launch_tools dry-run: flops {rec['flops']:.6e} outside the "
             f"split's analytic {split:.6e} +- {FLOPS_TOL}")
    if rec["collective_counts"]["all-gather"] <= 0:
        fail(f"launch_tools dry-run: no all-gather in {rec}")
    if rec["memory"]["temp_bytes"] >= hbm:
        fail(f"launch_tools dry-run: temp_bytes {rec['memory']['temp_bytes']}"
             f" over the card's {hbm:.0f}")
    dec = _dryrun_child(DRYRUN_DECODE_CELL)
    peak = dec["memory"]["argument_bytes"] + dec["memory"]["temp_bytes"]
    print(f"launch_tools dry-run {DRYRUN_DECODE_CELL}: arguments + "
          f"temporaries {peak} B, {peak / hbm:.4f} of the card's {hbm:.0f} "
          f"({CARD})", flush=True)
    if peak > 0.9 * hbm:
        fail(f"launch_tools dry-run {DRYRUN_DECODE_CELL}: peak {peak} B over "
             f"0.9 x {hbm:.0f}")
    secs["c"] = time.perf_counter() - t0


def profile_pass(torch, label: str, fn, top: int = 10):
    """Where one pass's time goes: the profiler's device time by kernel
    name, and the device's busy share of the pass's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"serve {label} profile: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall (idle share {1 - busy / wall:.4f} under the "
          f"profiler), {sum(r[1] for r in rows)} device events", flush=True)
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        print(f"serve {label} profile: {ms:10.3f} ms "
              f"{100 * ms / max(busy, 1e-9):6.2f}% x{n:<5d} {key[:90]}",
              flush=True)
    # the port's own kernels, in or out of the top rows
    for prefix in KERNEL_PREFIXES:
        mine = [r for r in rows if prefix in r[2]]
        LAUNCH_NAMES[prefix].update(
            r[2][r[2].index(prefix):].split("(")[0] for r in mine)
        if mine:
            ms = sum(r[0] for r in mine)
            print(f"serve {label} profile: {prefix}* {ms:.3f} ms "
                  f"{100 * ms / max(busy, 1e-9):.2f}% "
                  f"x{sum(r[1] for r in mine)}", flush=True)


def timing_row(torch, name, shape, kern, plain, library, nbytes, flops,
               peak):
    b_ms, b_by = bound(nbytes, flops, peak)
    t0 = time.perf_counter()
    row = {"name": name, "shape": list(shape),
           "ms": median_ms(torch, kern), "plain_ms": median_ms(torch, plain),
           "library_ms": None if library is None
           else median_ms(torch, library),
           "bound_ms": b_ms, "bound_by": b_by,
           "device_ms": device_ms(torch, kern),
           "plain_device_ms": device_ms(torch, plain, reps=5),
           "library_device_ms": None if library is None
           else device_ms(torch, library),
           # by launch: tools/time_{attention,ssd}_bwd.py (the profiler
           # pass here gave nothing in PR 24's last run)
           "device_ms_by_launch": {}}
    print(f"seconds time {name} {list(shape)}: "
          f"{time.perf_counter() - t0:.1f} ({CARD})", flush=True)
    print(f"time {name} {row['shape']}: kernel {row['ms']:.4f} ms "
          f"(device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms "
          f"(device {row['plain_device_ms']:.4f}), library "
          f"{row['library_ms']} ms (device {row['library_device_ms']}), "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return row


def sdpa_mask(np, case):
    """The (Tq, Tk) boolean mask of (B, H, Hk, Tq, Tk, hd, causal,
    window[, q_offset, kv_start]) that ``scaled_dot_product_attention``
    takes: True where a key is visible."""
    Tq, Tk = case[3], case[4]
    m = mask_of(case)
    qp = m["q_offset"] + np.arange(Tq)[:, None]
    kp = np.arange(Tk)[None, :]
    vis = np.broadcast_to(kp >= m["kv_start"], (Tq, Tk)).copy()
    if m["causal"]:
        vis &= qp >= kp
    if m["window"] > 0:
        vis &= (qp - kp) < m["window"]
    return vis


def shifted(case) -> bool:
    """A window, a q_offset or a kv_start: SDPA takes the mask explicitly."""
    m = mask_of(case)
    return bool(m["window"] or m["q_offset"] or m["kv_start"])


def time_flash(torch, np, fa, ref, case):
    """``flash_attention`` at one (B, H, Hk, Tq, Tk, hd, causal, window[,
    q_offset, kv_start]), bf16, beside its plain version and
    ``scaled_dot_product_attention`` (``enable_gqa`` for grouped kv heads,
    an explicit boolean mask for a window or a shifted frame)."""
    B, H, Hk, Tq, Tk, hd, causal = case[:7]
    fmask = mask_of(case)
    q, k, v = flash_inputs(torch, np, case, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if causal and not shifted(case) else torch.as_tensor(
        sdpa_mask(np, case), device="cuda")

    def library():
        if mask is None:
            return sdpa(q, k, v, is_causal=True, enable_gqa=H != Hk)
        return sdpa(q, k, v, attn_mask=mask, enable_gqa=H != Hk)
    row = timing_row(
        torch, "flash_attention", case,
        lambda: fa.flash_attention(q, k, v, **fmask),
        lambda: ref.flash_attention_ref(q, k, v, **fmask), library,
        2 * (2 * B * H * Tq * hd + 2 * B * Hk * Tk * hd),
        attention_flops(case), BF16_FLOPS_PER_S)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def time_flash_bwd(torch, np, mods, ref, case):
    """The backward kernel at one (B, H, Hk, Tq, Tk, hd, causal, window[,
    q_offset, kv_start]), bf16, beside the backward of autograd through
    the plain version and of ``scaled_dot_product_attention``
    (``enable_gqa``; the mask explicit as in :func:`time_flash`), each over a
    graph kept for repeated backwards.  Bound: the forward's operations
    times 2.5 (five products against two) or the bytes of q, k, v, o, dO
    and lse read and dQ, dK, dV written, whichever is larger."""
    fa, fab = mods["flash_attention"], mods["flash_attention_bwd"]
    B, H, Hk, Tq, Tk, hd, causal = case[:7]
    fmask = mask_of(case)
    q, k, v = flash_inputs(torch, np, case, torch.bfloat16)
    dout = flash_inputs(torch, np, case, torch.bfloat16, seed=5)[0]
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **fmask)
    plain_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = ref.flash_attention_ref(*plain_in, **fmask)
    lib_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mask = None if not shifted(case) else torch.as_tensor(
        sdpa_mask(np, case), device="cuda")
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *lib_in, is_causal=causal and mask is None, attn_mask=mask,
        enable_gqa=H != Hk)
    row = timing_row(
        torch, "flash_attention_bwd", case,
        lambda: fab.flash_attention_bwd(q, k, v, out, dout, lse, **fmask),
        lambda: torch.autograd.grad(plain_out, plain_in, dout,
                                    retain_graph=True),
        lambda: torch.autograd.grad(lib_out, lib_in, dout,
                                    retain_graph=True),
        2 * (4 * B * H * Tq * hd + 4 * B * Hk * Tk * hd) + 4 * B * H * Tq,
        2.5 * attention_flops(case), BF16_FLOPS_PER_S)
    del q, k, v, dout, out, lse, plain_in, plain_out, lib_in, lib_out
    torch.cuda.empty_cache()
    return row


def ssd_bwd_work(case):
    """The SSD backward's bytes and flops at one (B, T, H, hd, N, C), xh
    and dy in bf16, no final-state gradient: the bytes of xh, dy, dt, A, B,
    C and the forward's per-chunk states read and of dxh, ddt, dA, dB and
    dC written; the products (G = C B^T a chunk; a head's four causal
    triangles, dy x^T, W^T dy, dS B and dS^T C, and four C x hd x N
    products)."""
    B, T, H, hd, N, C = case
    C = min(C, T)
    nc = -(-T // C)
    nbytes = 2 * 3 * B * T * H * hd + 4 * (2 * B * T * H + 2 * H
                                           + 4 * B * T * N
                                           + B * nc * H * hd * N)
    flops = B * nc * (2 * C * C * N + H * (C * (C + 1) * (2 * hd + 2 * N)
                                           + 8 * C * hd * N))
    return nbytes, flops


def time_ssd_bwd(torch, np, mods, ref, case, h0=False):
    """The SSD scan's backward kernel at one (B, T, H, hd, N, C), xh and dy
    in bf16, no final-state gradient (as training gives it), beside the
    backward of autograd through the plain scan over a graph kept for
    repeated backwards; no single PyTorch call computes it (library none).
    With ``h0`` the forward starts from an incoming state and the backward
    gives its gradient too (a split sequence's rank block: its gradient
    written adds to the bytes; h0 itself is the first chunk's saved
    state, which ``ssd_bwd_work`` already reads).  Bound:
    ``ssd_bwd_work``'s bytes over the memory rate or its products at the
    bf16 tensor-core peak, whichever is larger."""
    ssd, ssdb = mods["ssd_scan"], mods["ssd_scan_bwd"]
    B, T, H, hd, N, C = case
    ins, dy, dh = ssd_bwd_inputs(torch, np, case, torch.bfloat16)
    hin = dh * 0.1 if h0 else None
    C = min(C, T)
    _, _, states = ssd.ssd_scan_with_states(*ins, chunk=C, h0=hin)
    plain_in = [t.clone().requires_grad_(True) for t in ins]
    want = plain_in
    if h0:
        want = plain_in + [hin.clone().requires_grad_(True)]
    plain_y, _ = ref.ssd_scan_ref(*plain_in, chunk=C,
                                  h0=want[5] if h0 else None)
    nbytes, flops = ssd_bwd_work(case)
    nbytes += 4 * B * H * hd * N if h0 else 0
    row = timing_row(
        torch, "ssd_scan_bwd", list(case) + (["h0"] if h0 else []),
        lambda: ssdb.ssd_scan_bwd(*ins, states, dy, None, chunk=C,
                                  with_dh0=h0),
        lambda: torch.autograd.grad(plain_y, want, dy, retain_graph=True),
        None, nbytes, flops, BF16_FLOPS_PER_S)
    del ins, dy, dh, hin, states, plain_in, want, plain_y
    torch.cuda.empty_cache()
    return row


def time_kernels(torch, np, mods, ref, shapes):
    """Each kernel at its largest main-path shape."""
    mh, pd, fa, ssd = (mods[k] for k in ("margin_head", "pairwise_sqdist",
                                         "flash_attention", "ssd_scan"))
    rows = []
    g = card_generator(torch, 2)
    for T, D, V in shapes["margin_head"]:
        h = normal(torch, (T, D), g)
        w = normal(torch, (D, V), g, 0.1)
        # fp32 in, 4 fp32 outputs per row; the product and ~6 flops per
        # logit for the online statistics
        rows.append(timing_row(
            torch, "margin_head", (T, D, V), lambda: mh.margin_head(h, w),
            lambda: ref.margin_head_ref(h, w), None,
            4 * (T * D + D * V) + 16 * T, 2 * T * D * V + 6 * T * V,
            FP32_FLOPS_PER_S))
        del h, w
    for N, M, D in shapes["pairwise_sqdist"]:
        x = normal(torch, (N, D), g)
        c = normal(torch, (M, D), g)
        # the bound's operations: x.c as six bf16 products on the tensor
        # cores (the norms and the epilogue, O(N M + (N + M) D), are noise)
        rows.append(timing_row(
            torch, "pairwise_sqdist", (N, M, D),
            lambda: pd.pairwise_sqdist(x, c),
            lambda: ref.pairwise_sqdist_ref(x, c),
            lambda: torch.cdist(x, c).square(),
            4 * (N * D + M * D + N * M), 6 * 2 * N * M * D,
            BF16_FLOPS_PER_S))
        del x, c
        torch.cuda.empty_cache()
    for case in shapes["flash_attention"]:
        rows.append(time_flash(torch, np, fa, ref, case))
    for case in shapes["flash_attention_bwd"]:
        rows.append(time_flash_bwd(torch, np, mods, ref, case))
    # a split sequence's rank block, from an incoming state: first, so that
    # the largest shape stays the last row
    for case, h0 in [(c, True) for c in shapes.get("ssd_scan_h0", [])] + [
            (c, False) for c in shapes["ssd_scan"]]:
        B, T, H, hd, N, C = case
        ins = ssd_inputs(torch, np, case, torch.bfloat16)
        hin = normal(torch, (B, H, hd, N), card_generator(torch, 7)) \
            if h0 else None
        C = min(C, T)
        # xh and y bf16; dt, B, C and the final state fp32 (and h0)
        nbytes = 2 * 2 * B * T * H * hd + 4 * (B * T * H + H + 2 * B * T * N
                                               + (2 if h0 else 1)
                                               * B * H * hd * N)
        rows.append(timing_row(
            torch, "ssd_scan", list(case) + (["h0"] if h0 else []),
            lambda: ssd.ssd_scan(*ins, chunk=C, h0=hin),
            lambda: ref.ssd_scan_ref(*ins, chunk=C, h0=hin), None, nbytes,
            ssd_flops(case), BF16_FLOPS_PER_S))
        del ins, hin
        torch.cuda.empty_cache()
    for case in shapes.get("ssd_scan_h0", []):
        rows.append(time_ssd_bwd(torch, np, mods, ref, case, h0=True))
    for case in shapes["ssd_scan_bwd"]:
        rows.append(time_ssd_bwd(torch, np, mods, ref, case))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", type=int, default=50_000)
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--serve-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=32)
    # the mesh phase's campaign runs in a child process of this script
    ap.add_argument("--mesh-campaign", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_campaign:
        mesh_campaign_child(args.pool, args.max_iters, args.mesh_campaign)
        return

    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as e:
        fail(f"the port is not here ({e})")
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        fail(f"imported the port from {repro_torch.__file__}, not {ROOT}")
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import margin_head as mh
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as ssdb
    from repro_torch.serving import engine  # noqa: F401 (the serving path)
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules) or "repro" in sys.modules:
        fail("JAX or the JAX package was imported")
    mods = {"margin_head": mh, "pairwise_sqdist": pd, "flash_attention": fa,
            "ssd_scan": ssd, "flash_attention_bwd": fab, "ssd_scan_bwd": ssdb}

    global CARD
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    t_phase = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        print(f"phase {name} seconds: {now - t_phase[0]:.1f}", flush=True)
        t_phase[0] = now
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in build.LOG.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                # the kernel, by its mangled name from the file hash on
                at = entry.find("_cu_")
                short = entry[at + 4:at + 80] if at >= 0 else entry[:76]
                print(f"ptxas {name} {short}: {line.strip()}", flush=True)
    # the redesigned kernels run on tensor cores: their SASS holds HMMA
    # (mma.sync); the attention forward's and the two backwards' also wgmma
    # (HGMMA) fed by TMA tensor loads (UTMALDG)
    for name, ops in (("flash_attention", ("HMMA", "HGMMA", "UTMALDG")),
                      ("flash_attention_bwd", ("HMMA", "HGMMA", "UTMALDG")),
                      ("ssd_scan", ("HMMA",)),
                      ("ssd_scan_bwd", ("HMMA", "HGMMA", "UTMALDG")),
                      ("pairwise_dist", ("HMMA",))):
        counts = sass_instructions(build.nvcc(), libs[name], ops)
        for op, n in counts.items():
            print(f"sass {name}: {n} {op} instructions"
                  + (" (cuobjdump not found: not measured)" if n < 0
                     else ""), flush=True)
            if n == 0:
                fail(f"{name} compiled to no {op} instruction")

    timed("check margin_head grid", check_margin_head, torch, np, mh, ref,
          MARGIN_GRID)
    timed("check margin_head ties", check_margin_ties, torch, np, mh, ref,
          MARGIN_DUP_GRID)
    timed("check pairwise_sqdist grids", check_pairwise, torch, np, pd, ref,
          PAIRWISE_GRID, PAIRWISE_INT_GRID, PAIRWISE_REF_GRID)
    timed("check flash_attention grid", check_flash, torch, np, fa, ref,
          FLASH_GRID)
    timed("check flash_attention_bwd grid", check_flash_bwd, torch, np,
          mods, ref, FLASH_BWD_GRID)
    timed("check flash_attention pair at q_offset and kv_start",
          check_flash_offsets, torch, np, mods, ref)
    timed("check ssd_scan grid", check_ssd, torch, np, ssd, ref, SSD_GRID)
    timed("check ssd_scan states", check_ssd_states, torch, np, ssd, ref,
          SSD_GRID[4])
    for C, N, hd in ((128, 128, 64), (128, 64, 64)):
        for f32 in (False, True):
            print(f"ssd_scan_bwd shared memory bytes at C {C}, N {N}, hd "
                  f"{hd}, xh {'fp32' if f32 else 'bf16'}: "
                  f"{ssdb.smem_bytes(C, N, hd, f32)}", flush=True)
    timed("check ssd_scan_bwd grid", check_ssd_bwd, torch, np, ssd, ssdb,
          ref, SSD_BWD_GRID)
    timed("check ssd_scan pair chained through h0 and dh0",
          check_ssd_offsets, torch, np, ssd, ssdb, ref)
    phase("build and kernel checks")

    # the shapes each main path gave each kernel
    seen_by = {p: {k: set() for k in mods}
               for p in ("campaigns", "replay", "noisy", "fleet", "arch",
                         "serving", "serving_qwen2", "pool_pass",
                         "serving_gemma3", "serving_mamba2",
                         "pool_pass_mamba2", "serving_dbrx",
                         "serving_internvl2", "training_qwen2",
                         "training_gemma3",
                         "serving_whisper", "training_whisper",
                         "training_mamba2", "training_zamba2",
                         "mesh_compressed_dp", "sharded_train",
                         "sharded_serve", "sharded_trainer",
                         "sharded_train_mamba2", "sharded_serve_mamba2",
                         "sharded_serve_zamba2", "sharded_train_seq",
                         "sharded_train_mamba2_seq",
                         "sharded_prefill_seq_zamba2",
                         "sharded_prefill_seq_whisper", "mesh_halo")}
    mesh_secs: dict = {}     # the mesh phase's parts: (a) .. (d)
    sharded_secs: dict = {}  # the sharded phase's parts: (a) .. (g)
    launch_secs: dict = {}   # the launch_tools phase's parts: (a) .. (c)
    launch_launches: dict = {}   # the kernels its counted passes launched
    qwen2_steps: list = []   # qwen2-1.5b's training step seconds
    with tempfile.TemporaryDirectory() as tmp:
        camps = run_campaigns(torch, np, mh, pd, args.pool, args.max_iters,
                              seen_by["campaigns"], Path(tmp))
        x, y = camps["data"]
        restore = record_shapes(mh, "margin_head",
                                seen_by["campaigns"]["margin_head"],
                                margin_key)
        launcher, unmeshed, spent = run_launcher_campaign(
            torch, mh, x, y, camps["sync"], Path(tmp), args.max_iters)
        restore()
        t_mesh = time.perf_counter()
        mesh_launches = {"campaign": run_mesh_campaign(
            torch, Path(tmp), args.pool, args.max_iters, camps["sync"][0],
            (unmeshed, spent))}
        mesh_secs["a"] = time.perf_counter() - t_mesh
        run_kcenter_plain_distances(torch, x, y, args.max_iters,
                                    camps["kcenter_end"])
        replay = run_replay_campaigns(torch, pd,
                                      seen_by["replay"]["pairwise_sqdist"])
        noisy = run_noisy_campaign(torch, mh, x, y, Path(tmp),
                                   args.max_iters,
                                   seen_by["noisy"]["margin_head"])
        fleet = run_fleet(torch, mh, pd, x, y, Path(tmp), args.max_iters,
                          seen_by["fleet"])
        capped = run_capped_fleet(torch, mh, x, y, Path(tmp),
                                  args.max_iters)
        chaos, instrumented = run_chaos_and_instrumented(
            torch, mh, x, y, Path(tmp), args.max_iters,
            seen_by["noisy"]["margin_head"])
        arch_live, arch_replay = run_arch_selection(
            torch, mh, pd, x, y, args.max_iters, seen_by["arch"])
    phase("campaigns")
    check_aggregator(torch, np)
    check_retrain_graphs(torch, camps["task"], x, y, camps["sizes"])
    check_paged_sinks(torch, np, camps["task"], x)
    launches = camps["launches"]
    del camps
    phase("aggregator, retrain graphs, paged sinks")
    # the mesh phase's one-rank NCCL group, ("data", "model") = (1, 1)
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mesh_secs["group"] = time.perf_counter() - t0
    # zamba2-2.7b served (and meshed: sharded phase (e)), then trained from
    # the served weights at full depth with bf16 first moments (the
    # reference's lever for large models: fp32 ones put the update's two
    # copies of the slots near the card's 80 GB)
    served, _, trained_zamba2 = run_serving(
        torch, np, mods, "zamba2-2.7b", args.serve_batch, args.prompt_len,
        args.gen, seen_by["serving"],
        extra=_hooks(
            launch_tools_forward(torch, mods, launch_secs, launch_launches),
            sharded_serve(torch, np, mods, mesh,
                          seen_by["sharded_serve_zamba2"], sharded_secs,
                          mesh_launches, kernels=(
                              "margin_head", "flash_attention", "ssd_scan"),
                          part="e zamba2", path="sharded_serve_zamba2"),
            seq_prefill(torch, np, mods, mesh,
                        seen_by["sharded_prefill_seq_zamba2"], sharded_secs,
                        mesh_launches, kernels=("flash_attention",
                                                "ssd_scan"),
                        path="sharded_prefill_seq_zamba2")),
        train=train_lm(torch, np, mods, seen_by["training_zamba2"],
                       moment_dtype="bfloat16"))
    phase("serving and training zamba2-2.7b")
    # the dense LM labeler: qwen2-1.5b served, then its token-pool pass,
    # then trained from the served weights
    served_qwen2, pooled, trained_qwen2 = run_serving(
        torch, np, mods, "qwen2-1.5b", args.serve_batch, args.prompt_len,
        args.gen, seen_by["serving_qwen2"],
        pool_pass=pool_pass(torch, np, mods, seen_by["pool_pass"]),
        extra=_hooks(
            compressed_dp(torch, np, mods, mesh,
                          seen_by["mesh_compressed_dp"], mesh_secs,
                          mesh_launches),
            sharded_serve(torch, np, mods, mesh, seen_by["sharded_serve"],
                          sharded_secs, mesh_launches),
            sharded_train(torch, np, mods, mesh, seen_by["sharded_train"],
                          sharded_secs, mesh_launches,
                          seen_split=seen_by["sharded_train_seq"])),
        train=_then(train_lm(torch, np, mods, seen_by["training_qwen2"],
                             step_secs=qwen2_steps),
                    launch_tools_train(torch, mods, launch_secs,
                                       launch_launches, qwen2_steps)))
    phase("serving, pool pass and training qwen2-1.5b")
    # gemma3-4b (hd 256, local:global windows, tied 262k head) served at
    # full depth, then trained from the served weights cut to
    # GEMMA3_TRAIN_LAYERS (the attention backward at hd 256)
    served_gemma3, _, trained_gemma3 = run_serving(
        torch, np, mods, "gemma3-4b", args.serve_batch, args.prompt_len,
        args.gen // 2, seen_by["serving_gemma3"],
        train=train_lm(torch, np, mods, seen_by["training_gemma3"],
                       steps=GEMMA3_TRAIN_STEPS, layers=GEMMA3_TRAIN_LAYERS,
                       lr=GEMMA3_TRAIN_LR, loss_share=True))
    for path, kernel in (("serving_gemma3", "flash_attention"),
                         ("training_gemma3", "flash_attention_bwd")):
        windows = {s[7] for s in seen_by[path][kernel]}
        if windows != {0, 1024}:
            fail(f"gemma3-4b's {kernel} ran with windows "
                 f"{sorted(windows)} in {path}, want 0 (global layers) and "
                 f"1024 (local layers)")
    phase("serving and training gemma3-4b")
    # the rest of the zoo: mamba2-1.3b (ssd_scan at state N 128) and its
    # pool pass; dbrx-132b at full width, cut to DBRX_LAYERS of its 40
    # layers (the MoE block, GQA 48:8 at hd 128); internvl2-26b, cut to
    # INTERNVL2_LAYERS, with its 1,024 patch tokens before the prompt
    # mamba2-1.3b also trained and served on the mesh (sharded phases (d)
    # and (e)), its mixers on their heads' block over "model"
    served_mamba2, pooled_mamba2, trained_mamba2 = run_serving(
        torch, np, mods, "mamba2-1.3b", args.serve_batch, args.prompt_len,
        args.gen, seen_by["serving_mamba2"],
        pool_pass=pool_pass(torch, np, mods, seen_by["pool_pass_mamba2"]),
        extra=_hooks(
            launch_tools_forward(torch, mods, launch_secs, launch_launches),
            sharded_train(torch, np, mods, mesh,
                          seen_by["sharded_train_mamba2"], sharded_secs,
                          mesh_launches,
                          kernels=("ssd_scan", "ssd_scan_bwd"), part="d",
                          path="sharded_train_mamba2",
                          seen_split=seen_by["sharded_train_mamba2_seq"],
                          split_part="d fsdp_tp_seq"),
            sharded_serve(torch, np, mods, mesh,
                          seen_by["sharded_serve_mamba2"], sharded_secs,
                          mesh_launches, kernels=("margin_head", "ssd_scan"),
                          part="e mamba2", path="sharded_serve_mamba2")),
        train=train_lm(torch, np, mods, seen_by["training_mamba2"]))
    phase("serving, pool pass and training mamba2-1.3b")
    served_dbrx, _ = run_serving(
        torch, np, mods, "dbrx-132b", args.serve_batch, args.prompt_len,
        args.gen, seen_by["serving_dbrx"], layers=DBRX_LAYERS,
        extra=moe_routes(torch, mesh, mesh_secs))
    phase("serving dbrx-132b")
    served_internvl2, _ = run_serving(
        torch, np, mods, "internvl2-26b", args.serve_batch, args.prompt_len,
        args.gen, seen_by["serving_internvl2"], layers=INTERNVL2_LAYERS)
    phase("serving internvl2-26b")
    # the audio family: whisper-tiny served with 1,500 frames a request,
    # then trained from the served weights, checkpointed and resumed
    served_whisper, _, trained_whisper = run_serving(
        torch, np, mods, "whisper-tiny", args.serve_batch, args.prompt_len,
        args.gen, seen_by["serving_whisper"],
        extra=_hooks(
            sharded_trainer(torch, np, mods, mesh,
                            seen_by["sharded_trainer"], sharded_secs,
                            mesh_launches),
            seq_prefill(torch, np, mods, mesh,
                        seen_by["sharded_prefill_seq_whisper"],
                        sharded_secs, mesh_launches, prompt=448,
                        path="sharded_prefill_seq_whisper")),
        train=train_whisper_resume(torch, np, mods,
                                   seen_by["training_whisper"]))
    phase("serving and training whisper-tiny")
    check_halo(torch, mods, mesh, mesh_secs, mesh_launches,
               seen_by["mesh_halo"])
    torch.distributed.destroy_process_group()
    print(f"phase mesh seconds: {sum(mesh_secs.values()):.1f} (" + ", ".join(
        f"{k} {v:.1f}" for k, v in mesh_secs.items()) + f"; {CARD})",
        flush=True)
    print(f"phase sharded seconds: {sum(sharded_secs.values()):.1f} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(sharded_secs.items()))
          + f"; {CARD})", flush=True)
    if sum(sharded_secs.values()) > 180:
        print(f"phase sharded took {sum(sharded_secs.values()):.1f} s, "
              f"over its 180 s", flush=True)
    launch_tools_fits_and_dryrun(torch, launch_secs)
    print(f"phase launch_tools seconds: {sum(launch_secs.values()):.1f} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(launch_secs.items()))
          + f"; {CARD})", flush=True)
    if sum(launch_secs.values()) > 180:
        print(f"phase launch_tools took {sum(launch_secs.values()):.1f} s, "
              f"over its 180 s", flush=True)
    phase("launch tools: fits-proof and dry-run")
    from repro_torch.configs import get_config
    states = {s[4] for s in seen_by["serving_mamba2"]["ssd_scan"]}
    if states != {get_config("mamba2-1.3b").ssm_state}:
        fail(f"mamba2-1.3b's ssd_scan ran at states {sorted(states)}, "
             f"want {get_config('mamba2-1.3b').ssm_state}")
    lengths = {s[3] for s in seen_by["serving_internvl2"]["flash_attention"]}
    want = get_config("internvl2-26b").frontend_tokens + args.prompt_len
    if lengths != {want}:
        fail(f"internvl2-26b's attention ran over {sorted(lengths)} "
             f"positions, want the patches and the prompt, {want}")
    by_path = {k: {"campaigns": launches.get(k, 0),
                   "launcher_campaign": launcher if k == "margin_head" else 0,
                   "replay_campaigns": replay if k == "pairwise_sqdist"
                   else 0,
                   "noisy_campaign": noisy if k == "margin_head" else 0,
                   "fleet": fleet.get(k, 0),
                   "capped_fleet": capped if k == "margin_head" else 0,
                   "chaos_campaign": chaos if k == "margin_head" else 0,
                   "instrumented_campaign": instrumented
                   if k == "margin_head" else 0,
                   "arch_selection": arch_live.get(k, 0),
                   "arch_selection_replay": arch_replay
                   if k == "pairwise_sqdist" else 0,
                   "serving": served[k],
                   "serving_qwen2": served_qwen2[k],
                   "pool_pass_qwen2": pooled[k],
                   "serving_gemma3": served_gemma3[k],
                   "serving_mamba2": served_mamba2[k],
                   "pool_pass_mamba2": pooled_mamba2[k],
                   "serving_dbrx": served_dbrx[k],
                   "serving_internvl2": served_internvl2[k],
                   "training_qwen2": trained_qwen2[k],
                   "training_gemma3": trained_gemma3[k],
                   "serving_whisper": served_whisper[k],
                   "training_whisper": trained_whisper[k],
                   "training_mamba2": trained_mamba2[k],
                   "training_zamba2": trained_zamba2[k],
                   "mesh_campaign": mesh_launches["campaign"]
                   if k == "margin_head" else 0,
                   "mesh_compressed_dp":
                   mesh_launches["compressed_dp"][k],
                   "sharded_train": mesh_launches["sharded_train"][k],
                   "sharded_trainer": mesh_launches["sharded_trainer"][k],
                   "sharded_serve": mesh_launches["sharded_serve"][k],
                   "sharded_train_mamba2":
                   mesh_launches["sharded_train_mamba2"][k],
                   "sharded_serve_mamba2":
                   mesh_launches["sharded_serve_mamba2"][k],
                   "sharded_serve_zamba2":
                   mesh_launches["sharded_serve_zamba2"][k],
                   "sharded_train_seq": mesh_launches["sharded_train_seq"][k],
                   "sharded_train_mamba2_seq":
                   mesh_launches["sharded_train_mamba2_seq"][k],
                   "sharded_prefill_seq_zamba2":
                   mesh_launches["sharded_prefill_seq_zamba2"][k],
                   "sharded_prefill_seq_whisper":
                   mesh_launches["sharded_prefill_seq_whisper"][k],
                   "mesh_halo": mesh_launches["halo"][k],
                   "launch_tools": launch_launches.get(k, 0)}
               for k in mods}
    seen = {k: set().union(*(seen_by[p][k] for p in seen_by)) for k in mods}
    # every shape the main paths gave a kernel, held against the plain
    # version again; max_abs_err is the worst of these
    for name, shapes in seen.items():
        print(f"main-path shapes of {name}: {sorted(shapes)}", flush=True)
        if not shapes:
            fail(f"{name} was given no shape on the main paths")
    errs = {"margin_head": timed(
                "check margin_head main-path shapes", check_margin_head,
                torch, np, mh, ref, sorted(seen["margin_head"])),
            "pairwise_sqdist": timed(
                "check pairwise_sqdist main-path shapes", check_pairwise,
                torch, np, pd, ref, sorted(seen["pairwise_sqdist"])),
            "flash_attention": timed(
                "check flash_attention main-path shapes", check_flash,
                torch, np, fa, ref, sorted(seen["flash_attention"])),
            "ssd_scan": timed(
                "check ssd_scan main-path shapes", check_ssd, torch, np,
                ssd, ref, sorted(seen["ssd_scan"])),
            "flash_attention_bwd": timed(
                "check flash_attention_bwd main-path shapes",
                check_flash_bwd, torch, np, mods, ref,
                sorted(seen["flash_attention_bwd"])),
            "ssd_scan_bwd": timed(
                "check ssd_scan_bwd main-path shapes", check_ssd_bwd,
                torch, np, ssd, ssdb, ref, sorted(seen["ssd_scan_bwd"]))}
    phase("kernel checks at the main paths' shapes")
    # timed at the largest main-path shape of each (margin_head at the
    # largest of each path: the campaigns', the selection's other widths
    # and the LM heads': zamba2's, qwen2's, the pool pass's, mamba2's and
    # its pool pass's, dbrx's, internvl2's and gemma3's, that last;
    # pairwise_sqdist at the live k-center's, the fleet's, the selection's
    # other widths and the replay k-center's, that last; flash_attention
    # at zamba2's, qwen2's, the pool pass's, dbrx's, gemma3's local and
    # global layers', whisper's, the split's last rank block, the halo frame
    # and internvl2's, that last; its backward at each of whisper's training
    # shapes (encoder, decoder, cross-attention), the split block, the
    # halo frame, gemma3's local and global training layers, then zamba2's
    # and qwen2's, that last; ssd_scan at the rank blocks of
    # mamba2's and zamba2's mixers (16 "model" ranks), zamba2's state N 64,
    # mamba2's pool pass's and mamba2's serving shape, N 128, that last;
    # its backward at the rank blocks, then zamba2's and mamba2's
    # training shapes, that last; the pair at a 16-way sequence block of
    # mamba2's training shape, from h0 and from zeros)
    def widest(shapes, size, width):
        return [max((s for s in shapes if width(s) == w),
                    key=lambda s: (size(s), s))
                for w in sorted({width(s) for s in shapes})]
    camp_d = {s[1] for s in seen_by["campaigns"]["margin_head"]}
    rows = time_kernels(torch, np, mods, ref, {
        "margin_head": [max(seen_by["campaigns"]["margin_head"],
                            key=lambda s: (s[0] * s[2], s))] + [
            s for s in widest(seen_by["arch"]["margin_head"],
                              lambda s: s[0] * s[2], lambda s: s[1])
            if s[1] not in camp_d] + [
            max(seen_by[p]["margin_head"], key=lambda s: (s[0] * s[2], s))
            for p in ("serving", "serving_qwen2", "pool_pass",
                      "serving_mamba2", "pool_pass_mamba2", "serving_dbrx",
                      "serving_internvl2", "serving_whisper",
                      "serving_gemma3")],
        "pairwise_sqdist": [max(seen_by[p]["pairwise_sqdist"],
                                key=lambda s: (s[0] * s[1], s))
                            for p in ("campaigns", "fleet")] + [
            s for s in widest(seen_by["arch"]["pairwise_sqdist"],
                              lambda s: s[0] * s[1], lambda s: s[2])
            if s[2] not in (2, 64)] + [
            max(seen_by["replay"]["pairwise_sqdist"],
                key=lambda s: (s[0] * s[1], s))],
        "flash_attention": [
            max(seen_by[p]["flash_attention"],
                key=lambda s: (s[0] * s[1] * s[3] * s[4], s))
            for p in ("serving", "serving_qwen2", "pool_pass",
                      "serving_dbrx")] + [
            max((s for s in seen_by["serving_gemma3"]["flash_attention"]
                 if s[-1] == w), key=lambda s: (s[0] * s[1] * s[3] * s[4], s))
            for w in (1024, 0)] + sorted(
            seen_by["serving_whisper"]["flash_attention"]) + [
            FLASH_SPLIT[-1], FLASH_HALO] + [
            max(seen_by["serving_internvl2"]["flash_attention"],
                key=lambda s: (s[0] * s[1] * s[3] * s[4], s))],
        "flash_attention_bwd": sorted(
            seen_by["training_whisper"]["flash_attention_bwd"]) + [
            FLASH_SPLIT[-1], FLASH_HALO] + [
            max((s for s in seen_by["training_gemma3"]["flash_attention_bwd"]
                 if s[7] == w), key=lambda s: (s[0] * s[1] * s[3] * s[4], s))
            for w in (1024, 0)] + [
            max(seen_by[p]["flash_attention_bwd"],
                key=lambda s: (s[0] * s[1] * s[3] * s[4], s))
            for p in ("training_zamba2", "training_qwen2")],
        "ssd_scan_bwd": SSD_RANK_BLOCKS + [SSD_SPLIT_BLOCK] + [
            max(seen_by[p]["ssd_scan_bwd"],
                key=lambda s: (s[0] * s[1] * s[2], s))
            for p in ("training_zamba2", "training_mamba2")],
        "ssd_scan_h0": [SSD_SPLIT_BLOCK],
        "ssd_scan": SSD_RANK_BLOCKS + [SSD_SPLIT_BLOCK] + [
            max(seen_by[p]["ssd_scan"], key=lambda s: (s[0] * s[1] * s[2], s))
            for p in ("serving", "pool_pass_mamba2", "serving_mamba2")]})

    meta = {
        "margin_head": ("src/repro_torch/kernels/csrc/margin_head.cu",
                        "src/repro/kernels/margin_head.py:81"),
        "pairwise_sqdist": ("src/repro_torch/kernels/csrc/pairwise_dist.cu",
                            "src/repro/kernels/pairwise_dist.py:49"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:69"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:86"),
        # the gradient of the forward above: the TPU kernel has none
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:69"),
        # its gradient: the TPU kernel has none
        "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                         "src/repro/kernels/ssd_scan.py:86"),
    }
    prefixes = {"margin_head": "margin_head_",
                "pairwise_sqdist": "pairwise_sqdist_",
                "flash_attention": "flash_attention_",
                "flash_attention_bwd": "fa_bwd_", "ssd_scan": "ssd_scan_",
                "ssd_scan_bwd": "ssd_bwd_"}
    # bf16 at hd 64, 80 and 128 runs on the wgmma route: where the
    # profiler kept the forward's launches, one of them is that kernel
    names = sorted(LAUNCH_NAMES["flash_attention_"])
    print(f"flash_attention launch names in the profiled passes: "
          f"{names or 'none kept by the profiler (not measured)'}",
          flush=True)
    if names and not any(n.startswith("flash_attention_wgmma_kernel")
                         for n in names):
        fail(f"no profiled pass launched flash_attention_wgmma_kernel: "
             f"{names}")
    kernels = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["name"] == name]
        r = mine[-1]   # the largest shape
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "launch_names": sorted(LAUNCH_NAMES[prefixes[name]]),
            "max_abs_err": errs[name], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "device_ms_by_launch": r["device_ms_by_launch"],
            "shape": r["shape"],
            "other_shapes": [{k: o[k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "plain_device_ms",
                "bound_ms", "bound_by", "library_ms", "library_device_ms")}
                for o in mine[:-1]]})
    phase("kernel timing")
    print(f"chip_smoke wall seconds: {time.perf_counter() - t_start:.1f}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
