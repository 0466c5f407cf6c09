"""CLI: serve online test-time adaptation over HTTP (mirror of
`uni_adapter_tpu/cli/serve.py`).

Builds the configured backbone and text anchors (the evaluation CLI's
flags, `config.parse_args`) and exposes `serve.TTAServer` through the
micro-batching HTTP endpoint (`serve_http.HTTPTTAServer`):

    python -m uni_adapter_torch.cli.serve --checkpoint-path uni3d_L.pt \
        --precomputed-text-features large --port 8080 --warmup

    POST /register?client=ID, POST /submit?client=ID (npz body: pc[,rgb])
    -> npy logits; GET /healthz; snapshots by NAME under --snapshot-dir.
    See the serve_http module docstring for the whole protocol.

Serving flags are split off first, so the evaluation parser stays the one
source of model and data flags; `--help` prints both.  Runs on the GPU
unless `--device cpu` is passed (asked for `cuda` without one, it
raises).  `--warmup` runs one step of every ladder size at start-up, so
every kernel is built before the first request; a build that fails stops
the server from starting.  `--trunk-parallel tp` (or `pp`, with
`--trunk-stages` and `--pp-interleave`, or `sp`) under a multi-process
launch shards the encoder trunk over the world's ranks
(`parallel/trunk.py`, `serve.TTAServer(encode_fn=...)`), the clients'
carries replicated on every rank.

`--dist-mode ep` splits every client's classes over the ranks of a
multi-process launch (`serve.TTAServer(dist_mode='ep')`):

    python -m torch.distributed.run --nproc-per-node 2 \
        -m uni_adapter_torch.cli.serve --dist-mode ep ...

With either, rank 0 serves HTTP; every other rank follows it
(`serve.follow`) until rank 0 stops (an interrupt: it closes the
listener, then stops the followers).  Ranks that share a card run over gloo, ranks with a card
each over NCCL (`parallel/bootstrap.py`).
"""
from __future__ import annotations

import argparse
import logging
import os


def main(argv=None):
    """Start the server; returns the running `HTTPTTAServer` (the caller
    owns its lifetime: `close()`, then `server.stop()` under EP or TP),
    or None on a rank other than 0 of an EP or TP server, after it has
    followed rank 0 to its stop."""
    ap = argparse.ArgumentParser(
        prog="uni-adapter-serve",
        description="Serving flags (all other flags: evaluation parser "
                    "below)", add_help=False)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--gather-ms", type=float, default=2.0,
                    help="first-request gather window per tick")
    ap.add_argument("--sizes", default="1,2,4,8,16",
                    help="ladder of chunk sizes a tick is cut into")
    ap.add_argument("--snapshot-dir", default=None,
                    help="server-owned snapshot directory (default "
                         "<output-dir>/snapshots); clients reference "
                         "snapshots by NAME, never by path")
    ap.add_argument("--warmup", action="store_true",
                    help="run one step of every ladder size at start-up "
                         "(builds every kernel before the first request)")
    serve_args, rest = ap.parse_known_args(argv)
    if "-h" in (rest or []) or "--help" in (rest or []):
        print(ap.format_help())   # then the shared parser prints and exits

    from uni_adapter_torch.cli.tta import (check_backbone, feature_width,
                                           get_text_anchors_with_fallback,
                                           resolve_device, set_numerics)
    from uni_adapter_torch.config import parse_args
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.parallel.bootstrap import init_distributed_device
    from uni_adapter_torch.parallel.trunk import prepare_trunk_parallel
    from uni_adapter_torch.serve import TTAServer, follow
    from uni_adapter_torch.serve_http import HTTPTTAServer
    from uni_adapter_torch.utils.logging import setup_logging

    cfg = parse_args(rest)
    boot = init_distributed_device(cfg.run.device)
    device = boot["device"] or resolve_device(cfg.run.device)
    set_numerics()
    primary = boot["rank"] == 0
    os.makedirs(cfg.run.output_dir, exist_ok=True)
    setup_logging(os.path.join(cfg.run.output_dir, "serve.log")
                  if primary else None,
                  level=logging.INFO if primary else logging.WARNING)

    check_backbone(cfg.model.vlm3d)
    model, _, _ = build_backbone(cfg.model.vlm3d, cfg.model, device,
                                 seed=cfg.run.seed,
                                 checkpoint_path=cfg.model.checkpoint_path)
    if cfg.model.checkpoint_path is None:
        logging.warning("No checkpoint configured — random weights; "
                        "served logits are not meaningful.")
    # --trunk-parallel tp, pp or sp: the encoder over the world's ranks
    encode_fn = None
    if cfg.run.trunk_parallel != "none":
        model, encode_fn = prepare_trunk_parallel(cfg, model)
    text = get_text_anchors_with_fallback(cfg, device)
    width = feature_width(cfg.model)
    if text.shape[1] != width:
        raise ValueError(f"the anchors are {tuple(text.shape)}; --vlm3d "
                         f"{cfg.model.vlm3d} gives {width}-d features")
    sizes = tuple(int(s) for s in serve_args.sizes.split(","))
    server = TTAServer(cfg, model, text, sizes=sizes, seed=cfg.run.seed,
                       dist_mode=cfg.run.dist_mode, encode_fn=encode_fn)
    if not server.primary:
        follow(server)          # until rank 0 stops
        return None
    if serve_args.warmup:
        logging.info("warming up %d step sizes ...",
                     len(server.sizes) + (0 if 1 in server.sizes else 1))
        server.warmup(cfg.data.npoints)
    snapshot_dir = (serve_args.snapshot_dir
                    or os.path.join(cfg.run.output_dir, "snapshots"))
    http_srv = HTTPTTAServer(server, host=serve_args.host,
                             port=serve_args.port,
                             gather_ms=serve_args.gather_ms,
                             snapshot_dir=snapshot_dir).start()
    logging.info("serving TTA on %s:%d (sizes %s)", serve_args.host,
                 http_srv.port, tuple(server.sizes))
    return http_srv


def cli() -> int:
    """Serve until interrupted (rank 0; the other ranks of an EP server
    return when rank 0 stops them)."""
    http_srv = main()
    if http_srv is not None:
        try:
            http_srv.wait()
        except KeyboardInterrupt:
            logging.info("shutting down")
            http_srv.close()
            http_srv.server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
