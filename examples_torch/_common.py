"""Shared command line of the examples: ``--device`` (default ``cuda``;
the examples refuse to run on a card that is missing) and ``--dtype``."""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    return ap


def setup(args):
    """(device, dtype) of the parsed arguments; exits when the device is a
    card and CUDA is not available."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: no CUDA device is available "
                 "(pass --device cpu to run on the CPU)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    return device, torch.float32 if args.dtype == "f32" else torch.float64


def smoke() -> bool:
    """True under SMOKE=1: the reduced budget of the test suite's run."""
    return bool(os.environ.get("SMOKE"))


def final_violations(result, lane: int = 0) -> dict:
    it = int(result.stats.iter[lane])
    return {k: float(getattr(result.stats, k)[lane, it - 1])
            for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
