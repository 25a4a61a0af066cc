"""TEN-VAD evaluation CLI (port of the JAX package's
``examples/vad_ten_eval.py``), the analogue of the reference's
``examples/vad_ten_eval`` binary: macro/micro P/R/F1/FPR/FNR + RTFx over a
labeled testset, per file or (``--batched``) as one device pass.

    python -m melspec_tpu_torch.examples.vad_ten_eval \\
        --testset testdata/ten-vad
    python -m melspec_tpu_torch.examples.vad_ten_eval --min-energy 0.98 \\
        --min-y 11 --min-x 5 --min-mel 2 --min-speech-ms 150 \\
        --merge-gap-ms 150 --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.utils.vad_eval import (
    EvalOptions,
    decisions_to_segments,
    evaluate_testset,
    evaluate_testset_batched,
    macro_metrics,
    speed_metrics,
)
from melspec_tpu_torch.utils.vad_eval import preset as vad_preset


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--testset", type=Path,
                    default=_cli.REPO / "testdata" / "ten-vad")
    ap.add_argument("--fft-size", type=int, default=400)
    ap.add_argument("--hop-size", type=int, default=160)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--preset", choices=["balanced", "high-f1"],
                    default="balanced",
                    help="published operating point seeding the detector/"
                         "post-process knobs (reference doc/vad/README.md:"
                         "73-76); explicit flags below override it")
    ap.add_argument("--min-energy", type=float, default=None)
    ap.add_argument("--min-y", type=int, default=None)
    ap.add_argument("--min-x", type=int, default=None)
    ap.add_argument("--min-mel", type=int, default=None)
    ap.add_argument("--time-mode", choices=["start", "center", "end"],
                    default="center")
    ap.add_argument("--min-leading-active-columns", type=int, default=1)
    ap.add_argument("--min-active-columns", type=int, default=1)
    ap.add_argument("--min-confidence", type=float, default=0.0)
    ap.add_argument("--min-speech-ms", type=int, default=None)
    ap.add_argument("--merge-gap-ms", type=int, default=None)
    ap.add_argument("--max-files", type=int, default=None)
    _cli.add_device_flag(ap)
    ap.add_argument("--warmup", action="store_true",
                    help="run the testset once first so kernel builds and "
                         "first-call costs are excluded from the reported "
                         "RTFx (steady-state)")
    ap.add_argument("--batched", action="store_true",
                    help="run the whole testset as one batched device "
                         "pass (the serving shape)")
    ap.add_argument("--print-segments", action="store_true",
                    help="print predicted speech timestamp segments per file")
    args = ap.parse_args()
    dev = _cli.device(args)

    p_opts, p_settings = vad_preset(args.preset)

    def pick(flag, preset_val):
        return preset_val if flag is None else flag

    settings = DetectionSettings(
        min_energy=pick(args.min_energy, p_settings.min_energy),
        min_y=pick(args.min_y, p_settings.min_y),
        min_x=pick(args.min_x, p_settings.min_x),
        min_mel=pick(args.min_mel, p_settings.min_mel),
    )
    opts = EvalOptions(
        fft_size=args.fft_size, hop_size=args.hop_size, n_mels=args.n_mels,
        time_mode=args.time_mode,
        min_leading_active_columns=args.min_leading_active_columns,
        min_active_columns=args.min_active_columns,
        min_confidence=args.min_confidence,
        min_speech_ms=pick(args.min_speech_ms, p_opts.min_speech_ms),
        merge_gap_ms=pick(args.merge_gap_ms, p_opts.merge_gap_ms),
    )

    print(f"testset={args.testset}")
    print(
        f"preset={args.preset} fft_size={opts.fft_size} "
        f"hop_size={opts.hop_size} n_mels={opts.n_mels} "
        f"min_energy={settings.min_energy} min_y={settings.min_y} "
        f"min_x={settings.min_x} min_mel={settings.min_mel} "
        f"time_mode={opts.time_mode}"
    )
    print(
        f"postprocess min_speech_ms={opts.min_speech_ms} "
        f"merge_gap_ms={opts.merge_gap_ms}"
    )
    print()

    def print_file_segments(wav, rate, decisions):
        segments = decisions_to_segments(decisions, args.hop_size / rate)
        print(f"segments {wav.name}")
        for seg in segments:
            print(f"  {seg.start:.3f},{seg.end:.3f}")

    if args.print_segments and args.batched:
        # the batched path has no per-file decision hook; run the
        # sequential pipeline once for the printout (the batched pass
        # below still produces the timed metrics)
        evaluate_testset(args.testset, opts, settings,
                         max_files=args.max_files,
                         on_decisions=print_file_segments, device=dev)
        print()

    if args.batched:
        total, rows = evaluate_testset_batched(
            args.testset, opts, settings, max_files=args.max_files,
            warmup=args.warmup, device=dev,
        )
    else:
        if args.warmup:
            evaluate_testset(args.testset, opts, settings,
                             max_files=args.max_files, device=dev)
        total, rows = evaluate_testset(
            args.testset, opts, settings, max_files=args.max_files,
            on_decisions=(print_file_segments if args.print_segments
                          else None),
            device=dev,
        )
        if args.print_segments:
            print()

    print("=== Aggregate ===")
    print(
        f"all: frames={total.total} precision={total.precision:.4f} "
        f"recall={total.recall:.4f} f1={total.f1:.4f} "
        f"accuracy={total.accuracy:.4f} fpr={total.fpr:.4f} "
        f"fnr={total.fnr:.4f} tp={total.tp} fp={total.fp} tn={total.tn} "
        f"fn={total.fn}"
    )
    mm = macro_metrics(rows)
    print(
        f"macro: files={len(rows)} precision={mm['precision']:.4f} "
        f"recall={mm['recall']:.4f} f1={mm['f1']:.4f} "
        f"accuracy={mm['accuracy']:.4f} fpr={mm['fpr']:.4f} "
        f"fnr={mm['fnr']:.4f}"
    )
    sp = speed_metrics(rows)
    print(
        f"speed: audio_s={sp['audio_s']:.3f} wall_s={sp['wall_s']:.3f} "
        f"rtf={sp['rtf']:.6f} rtfx={sp['rtfx']:.2f}"
    )

    print()
    print("=== Per File ===")
    print("file,duration_s,wall_ms,rtf,rtfx,frames,precision,recall,f1,"
          "accuracy,fpr,fnr,tp,fp,tn,fn")
    for row in rows:
        m = row.metrics
        rtf = row.wall_s / row.duration_s if row.duration_s else 0.0
        rtfx = row.duration_s / row.wall_s if row.wall_s else 0.0
        print(
            f"{row.path.name},{row.duration_s:.3f},{row.wall_s*1000:.3f},"
            f"{rtf:.6f},{rtfx:.2f},{m.total},{m.precision:.4f},"
            f"{m.recall:.4f},{m.f1:.4f},{m.accuracy:.4f},{m.fpr:.4f},"
            f"{m.fnr:.4f},{m.tp},{m.fp},{m.tn},{m.fn}"
        )


if __name__ == "__main__":
    main()
