"""Flag-compatible CLI on the PyTorch port (``python -m lrge_tpu_torch``).

Mirrors ``lrge_tpu.cli.main`` with the port's two-set strategy; the
parser and logging set-up are the reference's own.  Prints the
genome-size estimate (in bp, rounded) to stdout or ``-o``.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from lrge_tpu.cli import build_parser, setup_logging
from lrge_tpu.errors import LrgeError
from lrge_tpu.strategy.twoset import DEFAULT_QUERY_NUM_READS, DEFAULT_TARGET_NUM_READS
from lrge_tpu.utils import create_temp_dir, format_estimate

from .strategy import TwoSetBuilder

logger = logging.getLogger("lrge")


def main(argv=None, device: torch.device | None = None) -> int:
    """Run the CLI; ``device`` pins the device engine's ``torch.device``
    (default: the one CUDA card)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.quiet and args.verbose:
        ap.error("the argument '--quiet' cannot be used with '--verbose'")
    if args.num_reads is not None and (
        args.target_num_reads is not None or args.query_num_reads is not None
    ):
        ap.error("the argument '--num <INT>' cannot be used with '--target/--query'")
    if args.num_reads is not None:
        raise NotImplementedError("the all-vs-all strategy (-n): ROADMAP.md item 9")
    if os.environ.get("LRGE_COORDINATOR"):
        raise NotImplementedError("multi-host runs (LRGE_COORDINATOR): ROADMAP.md item 13")
    setup_logging(args.quiet, args.verbose)

    tmp = create_temp_dir(args.temp_dir, args.keep_temp)
    (logger.info if args.keep_temp else logger.debug)(
        "Created temporary directory at %s", tmp.path
    )
    try:
        t = args.target_num_reads if args.target_num_reads is not None else DEFAULT_TARGET_NUM_READS
        q = args.query_num_reads if args.query_num_reads is not None else DEFAULT_QUERY_NUM_READS
        logger.info("Running two-set strategy with %d target reads and %d query reads", t, q)
        strategy = (
            TwoSetBuilder()
            .target_num_reads(t)
            .query_num_reads(q)
            .remove_internal(args.filter_contained, args.max_overhang_ratio)
            .use_min_ref(args.use_min_ref)
            .engine(args.engine)
            .device_paf(args.keep_temp)
            .threads(args.threads)
            .tmpdir(tmp.path)
            .seed(args.seed)
            .platform(args.platform)
            .device(device)
            .build(args.input)
        )
        try:
            result = strategy.estimate(
                finite=not args.with_infinity,
                lower_quant=args.lower_q,
                upper_quant=args.upper_q,
            )
        except LrgeError as e:
            print(f"Error: Failed to generate estimate: {e}", file=sys.stderr)
            return 1

        if result.estimate is None:
            if args.with_infinity:
                print("Error: No estimates were generated", file=sys.stderr)
            else:
                print("Error: No finite estimates were generated", file=sys.stderr)
            return 1

        est = result.estimate
        msg = f"Estimated genome size: {format_estimate(est)}"
        if result.lower is not None and result.upper is not None:
            msg += f" (IQR: {format_estimate(result.lower)} - {format_estimate(result.upper)})"
        logger.info(msg)

        if np.isnan(est):
            out_text = "NaN\n"  # Rust's float formatting
        elif args.precise:
            # shortest f32 representation, like Rust's f32 Display
            out_text = (
                "inf\n"
                if np.isinf(est)
                else np.format_float_positional(np.float32(est), unique=True, trim="-") + "\n"
            )
        else:
            out_text = f"{est:.0f}\n"
        if args.output == "-":
            sys.stdout.write(out_text)
        else:
            Path(args.output).write_text(out_text)
        logger.info("Done!")
        return 0
    finally:
        tmp.cleanup()


if __name__ == "__main__":
    sys.exit(main())
