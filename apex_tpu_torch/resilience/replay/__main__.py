"""``python -m apex_tpu_torch.resilience.replay`` — replay, bisect,
selftest (counterpart of apex_tpu/resilience/replay/__main__.py: the same
flags and exit codes, plus ``--device``).

Modes (one journal jsonl + the checkpoint dir it anchors to):

- **verify** (default): re-execute the journaled segment from the
  earliest restorable anchor and compare fingerprints. Exit 0 when
  consistent, 2 when a divergence was found (a verification failure),
  1 on error (no anchor, corpus mismatch, unbuildable target).
- ``--bisect``: locate the first divergent step, leaf, and layer
  (bisect.py) and print/emit the ``kind="divergence"`` forensic record.
  Exit 0 whether or not a divergence exists — FINDING one is this
  mode's success — 1 on error.
- ``--diff A B``: fingerprint-level diff of two journals, no
  re-execution (cross-run determinism check; host-only). Exit 0
  consistent / 2 divergent.
- ``--selftest``: exit-nonzero gate: record a tiny GPT run → replay it
  bitwise-clean → re-record with an injected in-memory bit flip the
  sentinel misses → bisect must pin the exact step AND the exact
  flipped leaf.

The step runs on ``--device`` (``cuda`` by default; without a card
every mode but ``--diff`` raises unless ``--device cpu`` is given).
``--json PATH`` appends the replay/divergence records (plus the goodput
spans replay books for its own restore + step time) to a jsonl in the
shared MetricRouter schema.
"""

import argparse
import os
import sys
import tempfile

from apex_tpu_torch.resilience.exit_codes import ExitCode


def _check(failures, ok, label):
    status = "ok" if ok else "FAIL"
    print(f"  [{status}] {label}", flush=True)
    if not ok:
        failures.append(label)


def _record_run(training, lm, ckpt_dir, journal_file, cfg, corpus_prefix,
                steps, save_interval, flags, bitflip_step=None,
                bitflip_seed=1):
    """A miniature recording loop: the example's journal wiring without
    its CLI/telemetry shell. Returns (flip_info, losses)."""
    from apex_tpu_torch.resilience import chaos, integrity
    from apex_tpu_torch.resilience.replay.journal import (
        FlightRecorder,
        batch_crc,
    )
    from apex_tpu_torch.utils.pytree import tree_copy_

    rec = FlightRecorder(journal_file)
    rec.header(
        "selftest", "gpt", config=cfg.to_json(),
        corpus={"prefix": corpus_prefix}, **flags,
    )
    state = training.init_state()
    rec.anchor(0, init=True)
    flip_info = None
    losses = []
    for step in range(steps):
        ids = list(range(step * cfg.global_batch,
                         (step + 1) * cfg.global_batch))
        x, y = lm.batch(ids)
        crc = batch_crc(x, y)
        state, loss, verdict, _, layer_rms = training.train_step(
            state, *training.reshape_batch(x, y))
        losses.append(loss)
        rec.step(
            step, batch=[ids[0], ids[-1] + 1], batch_crc=crc,
            inject_nan=0.0, lr_scale=1.0, loss=loss, verdict=verdict,
            layer_rms=layer_rms,
        )
        if bitflip_step is not None and step == bitflip_step:
            params, flip_info = chaos.bitflip_leaf(
                state.params, bit=12, seed=bitflip_seed,
                path_filter="['layer_1']",
            )
            tree_copy_(state.params, params)
            rec.event(step, "bitflip_injected", **flip_info)
        if (step + 1) % save_interval == 0:
            integrity.save_checkpoint_verified(ckpt_dir, step + 1,
                                               state.as_tuple())
            rec.anchor(step + 1)
    rec.close()
    return flip_info, losses


def selftest(directory=None, device="cuda") -> int:
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
    from apex_tpu_torch.resilience.replay.bisect import (
        bisect_divergence,
        format_divergence,
    )
    from apex_tpu_torch.resilience.replay.journal import load_journal
    from apex_tpu_torch.resilience.replay.replayer import (
        GPTReplayContext,
        compare_journals,
        determinism_guard,
        replay_segment,
    )
    from apex_tpu_torch.resilience.replay.targets import (
        GPTTargetConfig,
        build_gpt_training,
        synthetic_corpus,
    )

    device = resolve_device(device)
    directory = directory or tempfile.mkdtemp(prefix="apex_torch_replay_")
    failures = []
    print(f"replay selftest (dir {directory}, device {device})", flush=True)

    # pin the numerics flags BEFORE the step is built — both the
    # recording and the replay run under the same guard, which is half
    # of the bitwise claim (the other half is rebuilding the same step)
    flags = determinism_guard(device=device)
    flags["devices"] = 1
    cfg = GPTTargetConfig(
        vocab=64, seq_len=16, layers=2, hidden=32, heads=4, tp=1,
        micro_batch=1, global_batch=8, spike_warmup=4,
        collect_layer_rms=True,
    )
    corpus = synthetic_corpus(cfg.vocab, n_tokens=4_000)
    training = build_gpt_training(cfg, device=device)
    lm = LMDataset(IndexedTokenDataset(corpus), cfg.seq_len)
    steps, save_interval = 6, 2

    def build_context(journal):
        # replay through the step that recorded (the CLI rebuilds the
        # same step from the journal header instead)
        return GPTReplayContext(journal, training=training, lm=lm)

    # 1) clean recording + bitwise replay: zero divergence
    clean_dir = os.path.join(directory, "clean")
    clean_journal = os.path.join(clean_dir, "replay-journal.jsonl")
    os.makedirs(clean_dir, exist_ok=True)
    _, losses = _record_run(training, lm, clean_dir, clean_journal, cfg,
                            corpus, steps, save_interval, flags)
    journal = load_journal(clean_journal)
    _check(failures, len(journal.steps) == steps and len(journal.anchors)
           == 1 + steps // save_interval,
           "journal carries every step + anchor")
    ctx = build_context(journal)
    report = replay_segment(ctx, clean_dir)
    print("  " + report.summary().replace("\n", "\n  "), flush=True)
    _check(failures, report.mode == "bitwise",
           "same-platform replay compares bitwise")
    _check(failures, report.ok and report.steps_replayed == steps,
           "clean run replays bitwise-identical, zero divergence")
    _check(failures, len(report.anchors_checked) >= 2,
           "per-leaf crc32 checked at crossed anchors")

    # 2) bisect on the clean journal: found=False
    clean_verdict = bisect_divergence(journal, clean_dir, ctx=ctx)
    _check(failures, clean_verdict.get("found") is False,
           "bisect on the clean journal reports no divergence")

    # 3) journal self-diff (the cross-run fingerprint path)
    diff = compare_journals(journal, journal)
    _check(failures, diff.ok, "journal self-diff is clean")

    # 4) bit-flip recording: one low-mantissa param bit flipped in
    # memory after step 3 (so the step-4 checkpoint carries it). The
    # sentinel must MISS it — every journaled verdict stays OK — and the
    # run completes; only the replay referee can catch it.
    flip_dir = os.path.join(directory, "bitflip")
    flip_journal = os.path.join(flip_dir, "replay-journal.jsonl")
    os.makedirs(flip_dir, exist_ok=True)
    flip_info, flip_losses = _record_run(
        training, lm, flip_dir, flip_journal, cfg, corpus, steps,
        save_interval, flags, bitflip_step=3,
    )
    fj = load_journal(flip_journal)
    _check(failures, all(r.get("verdict") == 0 for r in fj.steps.values()),
           "sentinel missed the bit flip (every verdict OK)")
    _check(failures, "['layer_1']" in flip_info["path"],
           "flip landed in a layer-1 leaf")

    # 5) the bisector pins the exact step and the exact flipped leaf
    ctx2 = build_context(fj)
    verdict = bisect_divergence(fj, flip_dir, ctx=ctx2)
    print("  " + format_divergence(verdict).replace("\n", "\n  "),
          flush=True)
    _check(failures, verdict.get("found") is True, "bisect found the flip")
    _check(failures, verdict.get("step") == 4,
           f"pinned the first divergent step (4, got "
           f"{verdict.get('step')})")
    # manifest fingerprints path the full state TUPLE, so the params
    # leaf carries the tuple-slot prefix "[0]"
    _check(failures, verdict.get("exact_leaves") is True
           and verdict.get("leaves") == ["[0]" + flip_info["path"]],
           f"pinned the EXACT flipped leaf ({flip_info['path']})")
    _check(failures, verdict.get("layer") == 1,
           f"layer_out_rms localized the corrupted depth (layer 1, got "
           f"{verdict.get('layer')})")
    _check(failures, verdict.get("clean_anchor") == 2
           and verdict.get("dirty_anchor") == 4,
           "clean/dirty anchors bracket the flip")

    # 6) corruption at the LAST anchor boundary: flip after the final
    # journaled step, so the run-end checkpoint (one step past the last
    # step record) is the dirty anchor — the fine phase must end on the
    # anchor comparison, not demand a step record that never existed
    edge_dir = os.path.join(directory, "edge")
    edge_journal = os.path.join(edge_dir, "replay-journal.jsonl")
    os.makedirs(edge_dir, exist_ok=True)
    edge_info, _ = _record_run(
        training, lm, edge_dir, edge_journal, cfg, corpus, steps,
        save_interval, flags, bitflip_step=steps - 1,
    )
    ej = load_journal(edge_journal)
    everdict = bisect_divergence(ej, edge_dir, ctx=build_context(ej))
    _check(failures, everdict.get("found") is True
           and everdict.get("step") == steps
           and everdict.get("exact_leaves") is True
           and everdict.get("leaves") == ["[0]" + edge_info["path"]],
           f"last-anchor corruption pinned (step {steps}, exact leaf; "
           f"got step {everdict.get('step')})")

    if failures:
        print(f"replay selftest: {len(failures)} check(s) FAILED:",
              flush=True)
        for f in failures:
            print(f"  - {f}", flush=True)
        return int(ExitCode.FAILURE)
    print("replay selftest: all checks passed", flush=True)
    return int(ExitCode.OK)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.resilience.replay",
        description="deterministic replay & divergence forensics",
    )
    parser.add_argument("journal", nargs="?", default=None,
                        help="journal jsonl (or a checkpoint dir holding "
                             "replay-journal.jsonl)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint dir the journal anchors to "
                             "(default: the journal's own directory)")
    parser.add_argument("--from", dest="start", type=int, default=None,
                        help="anchor step to replay from (default: the "
                             "earliest restorable anchor)")
    parser.add_argument("--to", dest="stop", type=int, default=None,
                        help="last step to replay (default: newest "
                             "journaled step)")
    parser.add_argument("--mode", choices=("auto", "bitwise", "tolerance"),
                        default="auto",
                        help="fingerprint comparison: bitwise on the "
                             "recorded platform, tolerance-banded "
                             "otherwise (auto picks by platform match)")
    parser.add_argument("--rtol", type=float, default=1e-5)
    parser.add_argument("--bisect", action="store_true",
                        help="binary-search the first divergent step "
                             "across anchors and localize the leaf/layer")
    parser.add_argument("--diff", nargs=2, metavar=("A", "B"),
                        default=None,
                        help="fingerprint-diff two journals (no "
                             "re-execution)")
    parser.add_argument("--json", default=None,
                        help="append replay/divergence/span records to "
                             "this jsonl")
    parser.add_argument("--selftest", action="store_true",
                        help="record -> replay -> inject-bitflip -> "
                             "bisect round trip on a tiny target; exit "
                             "nonzero on any failed check")
    parser.add_argument("--dir", default=None,
                        help="selftest scratch dir (default: a temp dir, "
                             "kept for inspection)")
    parser.add_argument("--device", default="cuda",
                        help="where the step re-executes (default cuda; "
                             "cpu runs the plain torch path)")
    args = parser.parse_args(argv)

    if args.selftest:
        from apex_tpu_torch.resilience.replay.replayer import (
            numerics_flags_kept,
        )

        with numerics_flags_kept():
            return selftest(args.dir, args.device)
    if not args.diff:
        from apex_tpu_torch._kernels import resolve_device

        resolve_device(args.device)  # before any journal is read

    router = None
    if args.json:
        from apex_tpu_torch.monitor import goodput
        from apex_tpu_torch.monitor.router import JsonlSink, MetricRouter

        router = MetricRouter([JsonlSink(args.json)])
        goodput.set_router(router)

    try:
        if args.diff:
            from apex_tpu_torch.resilience.replay.journal import load_journal
            from apex_tpu_torch.resilience.replay.replayer import (
                compare_journals,
            )

            report = compare_journals(
                load_journal(args.diff[0]), load_journal(args.diff[1]),
                mode="bitwise" if args.mode != "tolerance" else "tolerance",
                rtol=args.rtol,
            )
            print(report.summary(), flush=True)
            if router is not None:
                for r in report.to_records():
                    router.emit(r)
            return int(ExitCode.OK if report.ok
                       else ExitCode.REPLAY_DIVERGENCE)

        if not args.journal:
            parser.error("a journal path (or --selftest / --diff) is "
                         "required")
        from apex_tpu_torch.resilience.replay.journal import load_journal

        journal = load_journal(args.journal)
        ckpt_dir = args.ckpt_dir
        if ckpt_dir is None:
            p = args.journal
            ckpt_dir = p if os.path.isdir(p) else os.path.dirname(
                os.path.abspath(p))

        if args.bisect:
            from apex_tpu_torch.resilience.replay.bisect import (
                bisect_divergence,
                format_divergence,
            )

            record = bisect_divergence(
                journal, ckpt_dir, stop=args.stop, mode=args.mode,
                rtol=args.rtol, router=router, device=args.device,
            )
            print(format_divergence(record), flush=True)
            return int(ExitCode.OK)

        from apex_tpu_torch.resilience.replay.replayer import (
            build_context,
            replay_segment,
        )

        with build_context(journal, device=args.device) as ctx:
            report = replay_segment(
                ctx, ckpt_dir, start=args.start, stop=args.stop,
                mode=args.mode, rtol=args.rtol,
            )
        print(report.summary(), flush=True)
        if router is not None:
            for r in report.to_records():
                router.emit(r)
        return int(ExitCode.OK if report.ok
                       else ExitCode.REPLAY_DIVERGENCE)
    finally:
        if router is not None:
            from apex_tpu_torch.monitor import goodput

            goodput.set_router(None)
            router.close()


if __name__ == "__main__":
    sys.exit(main())
