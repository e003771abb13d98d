"""Serving entry point: ``python -m raft_stereo_tpu_torch.serve``.

The JAX package's ``cli serve`` on the port: the stdlib HTTP front
(serve/http.py) over the continuous-batching scheduler, on the card unless
``--device cpu``. SIGTERM/SIGINT drain (stop admitting, finish every
admitted request, exit 0); with ``--ckpt_dir``, SIGHUP reloads the newest
manifest-valid checkpoint named ``--ckpt_name`` there (the trainer's
``<step>_<name>`` and final ``<name>`` directories) at a batch boundary.
"""

from __future__ import annotations

import logging
import signal


def main(argv=None) -> None:
    from raft_stereo_tpu_torch import cli
    from raft_stereo_tpu_torch.inference import resolve_device
    from raft_stereo_tpu_torch.serve.http import (make_http_server,
                                                  serve_forever)
    from raft_stereo_tpu_torch.serve.server import StereoServer
    from raft_stereo_tpu_torch.training.resilience import (SignalGuard,
                                                           find_latest_valid)
    from raft_stereo_tpu_torch.utils.weights import load_weights

    args = cli.build_serve_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(filename)s:%(lineno)d %(message)s")
    log = logging.getLogger("raft_stereo_tpu_torch.serve")
    serve_cfg = cli.serve_config(args)
    cfg = cli.model_config(args)
    state = load_weights(args.restore_ckpt, cfg)
    device = resolve_device(args.device)
    tel = None
    if args.run_dir:
        from raft_stereo_tpu_torch.obs import Telemetry
        from raft_stereo_tpu_torch.obs.trace import Tracer
        tel = Telemetry(args.run_dir, stall_deadline_s=None,
                        host_id=args.host_id, fleet=not args.no_fleet,
                        device=device)
        Tracer(tel)  # request-lifecycle spans (attaches as tel.tracer)
        tel.run_start(config={"mode": "serve", "port": args.port,
                              "max_batch": args.max_batch,
                              "window": args.window, "iters": args.iters,
                              "iter_policy": args.iter_policy,
                              "adaptive": args.adaptive,
                              "device": str(device)})
    server = StereoServer(cfg, state, serve_cfg, device=device,
                          telemetry=tel)
    if tel is not None:
        # the beats carry the served-request count, so a fleet rollup sees
        # a host that is up but makes no progress
        tel.start_heartbeat("serve", args.heartbeat_every,
                            probe=lambda: {"completed": server.slo.completed})
    if args.warm_shapes:
        n = server.warmup(cli._parse_shapes(args.warm_shapes),
                          batch_sizes=(1, args.max_batch))
        log.info("serve: warmed %d bucket programs", n)

    reload_wanted = [False]
    if args.ckpt_dir:
        signal.signal(signal.SIGHUP,
                      lambda *_: reload_wanted.__setitem__(0, True))

    def maybe_reload():
        if not reload_wanted[0]:
            return
        reload_wanted[0] = False
        ckpt, _reports = find_latest_valid(args.ckpt_dir, args.ckpt_name)
        if ckpt is None:
            raise RuntimeError(
                f"no manifest-valid checkpoint under {args.ckpt_dir}")
        server.reload(load_weights(ckpt, cfg), note=ckpt)
        log.info("serve: reload of %s requested", ckpt)

    httpd = make_http_server(server, args.host, args.port,
                             metrics=not args.no_metrics,
                             host_id=tel.host_id if tel is not None else None)
    with SignalGuard() as guard:
        rc = serve_forever(server, httpd,
                           should_stop=lambda: guard.requested,
                           maybe_reload=maybe_reload if args.ckpt_dir
                           else None,
                           drain_timeout_s=args.drain_timeout_s)
    httpd.server_close()
    if tel is not None:
        tel.emit("run_end", steps=server.slo.completed, ok=rc == 0)
        tel.close()
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
