#!/usr/bin/env python3
"""The chunked serving runs (a)-(c) of two source trees on one card, in turns.

    python3 scripts/torch_prefix_ab.py --other DIR [--rounds 1]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of the parent commit in a gitignored directory).
Each turn is a child process that imports ``repro_torch`` from one tree's
``src`` and serves, through that tree's ``serve_demo``, the runs of
``chip_smoke.serve_shared``: (a) paged chunked, (b) + prefix_share, (c) +
grouped_decode; 8 requests whose first 512 tokens are shared, budgets
16-48, chunks of 256, paged, max_batch 4, kvp 1, bf16, seeded random
weights.  granite-3-2b (40 layers) takes prompts of 768-1024 tokens,
gemma3-12b (48 layers) prompts of 1024-1536.  A short warm-up run comes
before each model's runs.  Each round runs the turns other, this, this,
other.

Prints the card line, one line per run and turn (TTFT p50, TTL p50, tok/s,
wall, prefill chunks, prefix_hit_rate), and each tree's mean per run.
Exits 1 unless every run's streams are equal across turns and across
(a)-(c).
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = (("granite-3-2b", (768, 1024)), ("gemma3-12b", (1024, 1536)))
RUNS = (("a paged chunked", {}),
        ("b + prefix_share", {"prefix_share": True}),
        ("c + grouped_decode", {"prefix_share": True,
                                "grouped_decode": True}))
KEYS = ("ttft_p50_ms", "ttl_p50_ms", "tok_s", "wall_s")


def child(root: str) -> int:
    """Serve the runs with ``root``'s package; one ``RESULT`` line each."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models.transformer import init_params

    build.build_all()
    dev = torch.device("cuda", 0)
    for arch, prompt_len in MODELS:
        model = init_params(get_config(arch), 0, dtype=torch.bfloat16,
                            device=dev)
        base = dict(max_batch=4, kvp=1, paged_kv=True, chunk_tokens=256,
                    shared_prefix_len=512, dtype=torch.bfloat16, device=dev,
                    model=model, seed=0, log=lambda *a: None)
        serve_demo(arch, n_requests=2, prompt_len=600, max_new=4,
                   prefix_share=True, grouped_decode=True, **base)
        for name, extra in RUNS:
            fin, summ = serve_demo(arch, n_requests=8, prompt_len=prompt_len,
                                   max_new=(16, 48), **extra, **base)
            streams = json.dumps(sorted((r.rid, r.out_tokens) for r in fin))
            print("RESULT " + json.dumps({
                "arch": arch, "run": name,
                "ttft_p50_ms": summ["ttft_s"]["p50"] * 1e3,
                "ttl_p50_ms": summ["ttl_s"]["p50"] * 1e3,
                "tok_s": summ["tok_s"], "wall_s": summ["wall_s"],
                "prefill_calls": summ["prefill_calls"],
                "prefix_hit_rate": summ["prefix_hit_rate"],
                "streams": hashlib.sha256(streams.encode()).hexdigest()[:16]}),
                flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    if not args.other:
        ap.error("--other DIR is required")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_prefix_ab: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    trees = {"other": os.path.abspath(args.other), "this": HERE}
    results = []
    for tag in ("other", "this", "this", "other") * args.rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", trees[tag]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{tag}: child failed (rc {proc.returncode})\n"
                  f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("RESULT "):
                r = dict(json.loads(line[7:]), tree=tag)
                results.append(r)
                print(f"{tag:5s} {r['arch']} {r['run']}: TTFT p50 "
                      f"{r['ttft_p50_ms']:.1f} ms, TTL p50 "
                      f"{r['ttl_p50_ms']:.2f} ms, {r['tok_s']:.1f} tok/s, "
                      f"wall {r['wall_s']:.2f} s, {r['prefill_calls']} "
                      f"prefill chunks, prefix_hit_rate "
                      f"{r['prefix_hit_rate']:.4f}, streams {r['streams']}",
                      flush=True)
    ok = True
    for arch, _ in MODELS:
        hashes = {r["streams"] for r in results if r["arch"] == arch}
        print(f"{arch}: streams equal across turns and runs: "
              f"{len(hashes) == 1}")
        ok &= len(hashes) == 1
        for name, _ in RUNS:
            for tag in ("other", "this"):
                rs = [r for r in results if r["arch"] == arch
                      and r["run"] == name and r["tree"] == tag]
                print(f"  mean {tag:5s} {name}: " + ", ".join(
                    f"{k} {sum(r[k] for r in rs) / len(rs):.3f}"
                    for k in KEYS))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
