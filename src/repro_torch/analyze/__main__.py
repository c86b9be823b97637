"""``python -m repro_torch.analyze``: sweep the registry, exit nonzero on
errors.

Human-readable findings go to stderr; the machine-readable JSON report
goes to stdout (or to ``--json PATH``), so ``python -m
repro_torch.analyze > findings.json`` is always parseable.  Without
``--profile`` the device checks cover the built-in profiles and, when a
card is present, the card's runtime profile.

Exit codes: 0 clean, 1 error-severity findings (``--strict``: also
warnings), 2 usage errors (unknown kernel/profile).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..core.profiles import PROFILES, get_profile
from ..core.registry import KernelRegistry
from .lint import analyze_registry, render_text
from .space_audit import DEFAULT_EXACT_LIMIT, DEFAULT_SAMPLES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="Static analyzer for @tunable declarations: space "
                    "satisfiability, device-resource proofs, lint rules.")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on warnings too (CI gate)")
    ap.add_argument("--kernel", action="append", default=None,
                    metavar="NAME",
                    help="restrict to this kernel (repeatable)")
    ap.add_argument("--profile", action="append", default=None,
                    metavar="NAME",
                    help=f"restrict device checks to this profile "
                         f"(repeatable; known: {', '.join(sorted(PROFILES))})")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the JSON report here instead of stdout")
    ap.add_argument("--exact-limit", type=int, default=DEFAULT_EXACT_LIMIT,
                    help="max cardinality for exact enumeration "
                         "(default %(default)s)")
    ap.add_argument("--samples", type=int, default=DEFAULT_SAMPLES,
                    help="stratified sample size above the exact limit "
                         "(default %(default)s)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable listing on stderr")
    return ap


def main(argv: Optional[List[str]] = None,
         registry: Optional[KernelRegistry] = None) -> int:
    args = build_parser().parse_args(argv)
    profiles = None
    if args.profile:
        try:
            profiles = [get_profile(p) for p in args.profile]
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
    try:
        report = analyze_registry(registry, kernels=args.kernel,
                                  profiles=profiles,
                                  exact_limit=args.exact_limit,
                                  samples=args.samples)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if not args.quiet:
        print(render_text(report), file=sys.stderr)
    payload = report.dumps()
    if args.json:
        with open(args.json, "w") as f:
            f.write(payload + "\n")
    else:
        print(payload)
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":                            # pragma: no cover
    sys.exit(main())
