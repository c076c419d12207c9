"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/control.py --workload <name> --seeds 11,12,... \
        [--faults 3] [--control 3] --out FILE

For each seed: the program's sound run through its first steps (no
measured window) against the reference, which gives the lower reading of
each number compared; on the first `--faults` seeds, each fault of
`benchkit.faults` planted in the program; on the first `--control` seeds,
the control: the reference itself computed one precision below the
configuration's (bfloat16 convolutions and dense layers) in the program's
place, and the program with its own bf16 path (OTHERS.PRECISION bf16)
switched on; on the first `--witness` seeds, the program with cuDNN's TF32 off,
a witness of what the configuration's TF32 alone moves. The reference's
readings are computed once a seed. Writes one JSON line a reading to FILE.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import environment  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--faults", type=int, default=0)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--witness", type=int, default=0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    environment()

    import torch

    from benchkit import compare, faults, harness

    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    with open(args.out, "a") as out:
        def record(seed, variant, gaps, t):
            line = {"cell": cell.name, "seed": seed, "variant": variant, **gaps,
                    "seconds": time.perf_counter() - t}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)

        for i, seed in enumerate(seeds):
            t = time.perf_counter()
            want = None
            variants = ([None] + (list(faults.names(cell.method)) if i < args.faults else [])
                        + (["witness_f32"] if i < args.witness else [])
                        + (["program_bf16"] if i < args.control else []))
            if cell.batch < 2 and "half_batch" in variants:
                variants.remove("half_batch")  # a batch of one has no half to leave out
            for fault in variants:
                witness = fault == "witness_f32"
                plain = witness or fault == "program_bf16"
                others = {"PRECISION": "bf16"} if fault == "program_bf16" else None
                run = harness.Run(cell, seed, 0.0, False, "cuda", None if plain else fault, T0,
                                  others)
                torch.backends.cudnn.allow_tf32 = not witness
                run.build()
                run.drive()
                run.release()
                torch.backends.cudnn.allow_tf32 = True
                if want is None:
                    want = run.reference_readings()
                checks = run.judge(want)
                record(seed, fault or "sound",
                       {**{k: v["value"] for k, v in checks.items()}, **run.worst}, t)
                t = time.perf_counter()
            if i < args.control:
                run = harness.Run(cell, seed, 0.0, False, "cuda", None, T0)
                run.prepare()
                got = run.reference_readings(torch.bfloat16)
                record(seed, "control_bf16", compare.gaps(got, want, cell.model.HEADS), t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
