"""Worker process for tests/test_torch_distributed.py (the port's side).

Joins a gloo job on a local TCP coordinator, runs the port's distributed
stream driver over THIS process's input split, and dumps the final
register files and report JSON for the parent test to compare.  The
port's counterpart of ``tests/dist_worker.py``; it never imports jax.

Usage: _torch_dist_worker.py PROC_ID N_PROCS PORT RULESET_PREFIX LOG_PATH OUT_PREFIX
           [CKPT_DIR MODE [N_LOCAL]]

MODE (CKPT_DIR "-" where it takes none): "crash" checkpoints every 2
chunks and aborts after 3; "resume" resumes and runs to the end;
"stacked", "stacked-crash", "stacked-resume" and "stacked-abort" are the
stacked layout's; "die" joins the job and exits at once (code 3);
"survivor" runs normally with a short collective timeout; "-" is a plain
run.  N_LOCAL: CPU shards in this process (default 1), the reference
worker's fake devices a process; with a trailing "r" ("2r") the shards
alternate between two CPU devices (cpu, cpu:0), two register replicas
that merge in the process before the job's collectives.
"""

import sys


def main() -> int:
    proc_id, n_procs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    ruleset_prefix, log_path, out_prefix = sys.argv[4], sys.argv[5], sys.argv[6]
    ckpt_dir = sys.argv[7] if len(sys.argv) > 7 else None
    mode = sys.argv[8] if len(sys.argv) > 8 else None
    n_local_arg = sys.argv[9] if len(sys.argv) > 9 else "1"
    replicas = n_local_arg.endswith("r")
    n_local = int(n_local_arg.rstrip("r"))

    import torch

    torch.set_num_threads(1)

    from ruleset_analysis_tpu_torch.parallel import distributed as dist

    dist.init_distributed(f"127.0.0.1:{port}", n_procs, proc_id,
                          timeout=10 if mode in ("die", "survivor") else 60, device="cpu")
    if mode == "die":
        import os

        # abrupt death after joining the job: no shutdown handshake
        print(f"worker {proc_id} dying abruptly", file=sys.stderr, flush=True)
        os._exit(3)

    import numpy as np

    from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig
    from ruleset_analysis_tpu_torch.hostside import pack
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file_distributed

    packed = pack.load_packed(ruleset_prefix)
    cfg = AnalysisConfig(
        batch_size=64,
        sketch=SketchConfig(cms_width=1 << 10, cms_depth=4, hll_p=6),
        device="cpu",
        **(
            {"checkpoint_every_chunks": 2, "checkpoint_dir": ckpt_dir}
            if ckpt_dir and ckpt_dir != "-"
            else {}
        ),
        resume=mode in ("resume", "stacked-resume"),
        layout="stacked" if mode and mode.startswith("stacked") else "flat",
    )
    max_chunks = {"crash": 3, "stacked-abort": 2, "stacked-crash": 3}.get(mode)
    devices = ([torch.device("cpu"), torch.device("cpu", 0)] * (n_local // 2) if replicas
               else [torch.device("cpu")] * n_local)
    mesh = dist.make_global_mesh(devices=devices)
    try:
        report, regs = run_stream_file_distributed(
            packed, [log_path], cfg, return_state=True, max_chunks=max_chunks, mesh=mesh)
    finally:
        dist.shutdown()
    np.savez(out_prefix + ".npz", **regs)
    with open(out_prefix + ".json", "w", encoding="utf-8") as f:
        f.write(report.to_json())
    print(f"worker {proc_id}/{n_procs} done", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
