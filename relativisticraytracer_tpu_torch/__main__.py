"""Command-line launcher (port of relativisticraytracer_tpu.__main__; the
analog of the reference's run.bat + main()).

    python -m relativisticraytracer_tpu_torch still  [--width W --height H ...]
    python -m relativisticraytracer_tpu_torch anim   [--path-index N --fps 24 ...]
    python -m relativisticraytracer_tpu_torch interactive [--terminal ...]
    python -m relativisticraytracer_tpu_torch paths  # list built-in camera paths

Every command renders on a CUDA card (`--device cuda`, the default;
the kernels are built at first use) unless `--device cpu` asks for the
plain PyTorch versions. `--loop while` or `--loop scan` renders with the
plain march instead of the kernel programs, on either device.
"""

from __future__ import annotations

import argparse
import logging
import sys


# Resolution presets: reference step budget everywhere, only the pixel
# count changes. The port's frame times per preset on an H100 are in
# PERF.md (chip_smoke.py phase 11).
PRESETS = {
    "cinema": (1920, 1080),
    "preview": (960, 540),
    "native": (1000, 700),    # the reference's window (config.h:7-8)
    "realtime": (480, 272),
}

# Motion step cap per preset, the JAX package's values: while flying, the
# session marches with this cap and snaps back to full quality when you
# stop. Explicit --motion-steps always wins. Session tick times with and
# without motion on an H100 are in PERF.md (chip_smoke.py phase 11).
PRESET_MOTION_STEPS = {
    "native": 400,
    "realtime": 600,
}


def _positive_int(s):
    """argparse type: a strictly positive int, failing with a usage error
    instead of a silent degenerate render (octave cap 0 = no noise at all)."""
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _devices_arg(s):
    """'all' or a positive device count — validated at parse time so a typo
    fails with a usage error instead of a traceback (or a silent clamp)."""
    if s == "all":
        return s
    try:
        n = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'all' or a positive integer, got {s!r}"
        )
    if n <= 0:
        raise argparse.ArgumentTypeError(
            f"device count must be positive, got {n}"
        )
    return n


def _add_render_args(p):
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="resolution preset (cinema=1080p, preview=540p, "
                        "native=the reference's 1000x700 window, "
                        "realtime=480x272); explicit --width/--height win")
    p.add_argument("--width", type=int, default=None,
                   help="default 1000 (config.h:7) or the preset's width")
    p.add_argument("--height", type=int, default=None,
                   help="default 700 (config.h:8) or the preset's height")
    p.add_argument("--max-steps", type=int, default=2000)
    p.add_argument("--spin", type=float, default=0.0)
    p.add_argument("--no-disk", action="store_true")
    p.add_argument("--no-clouds", action="store_true")
    p.add_argument("--no-effects", action="store_true")
    p.add_argument("--octave-cap", type=_positive_int, default=None,
                   help="cap every fbm/ridge octave count in the media "
                        "noise, >= 1 (stylized preview; measured over the "
                        "parity budget — see PERF.md precision trades)")
    p.add_argument("--skybox", type=str, default=None,
                   help="equirect image path (procedural starfield if omitted)")
    p.add_argument("--loop", default=None, choices=["while", "scan", "pallas"],
                   help="march strategy (default: the kernel programs; while "
                        "and scan run the plain march)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda: the CUDA "
                        "kernels; cpu runs their plain PyTorch versions)")
    p.add_argument("--time", type=float, default=1.0)


def _build_renderer(args):
    from relativisticraytracer_tpu_torch.config import RenderSettings, SceneConfig
    from relativisticraytracer_tpu_torch.io.image import load_skybox
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer

    preset_wh = PRESETS.get(args.preset) if args.preset else None
    args.width = args.width or (preset_wh[0] if preset_wh else 1000)
    args.height = args.height or (preset_wh[1] if preset_wh else 700)
    scene = SceneConfig(
        spin_a=args.spin,
        max_steps=args.max_steps,
        enable_disk=not args.no_disk,
        enable_clouds=not args.no_clouds,
        noise_octave_cap=args.octave_cap,
    )
    settings = RenderSettings(
        width=args.width, height=args.height, max_steps=args.max_steps,
        loop=args.loop or "auto",
    )
    return Renderer(scene, settings,
                    skybox_rgba=load_skybox(args.skybox, device=args.device),
                    device=args.device)


def cmd_still(args):
    from relativisticraytracer_tpu_torch.config import CameraEffects, effects_off
    from relativisticraytracer_tpu_torch.io.image import save_png
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

    r = _build_renderer(args)
    cam = camera_state_from_pose(
        (args.cam_x, args.cam_y, args.cam_z), args.yaw, args.pitch
    )
    effects = effects_off() if args.no_effects else CameraEffects()
    frame = r.render_np(cam, effects, args.time)
    save_png(args.out, frame)
    print(f"wrote {args.out} ({args.width}x{args.height})")


def cmd_anim(args):
    from relativisticraytracer_tpu_torch.config import CameraEffects, effects_off
    from relativisticraytracer_tpu_torch.paths import default_paths
    from relativisticraytracer_tpu_torch.runtime.app import AnimationJob

    paths = default_paths()
    if not 0 <= args.path_index < len(paths):
        raise SystemExit(
            f"--path-index {args.path_index} out of range: "
            f"{len(paths)} paths (see the `paths` subcommand)"
        )
    path = paths[args.path_index]
    r = _build_renderer(args)   # resolves preset/default width+height
    if args.transfer == "yuv420p" and (args.width % 2 or args.height % 2):
        raise SystemExit(
            f"--transfer yuv420p needs even dimensions, got "
            f"{args.width}x{args.height}"
        )
    effects = effects_off() if args.no_effects else CameraEffects()
    job = AnimationJob(
        path=path, renderer=r, effects=effects, fps=args.fps,
        duration=args.duration, out_path=args.out,
        transfer=args.transfer,
    )
    devices = None
    if args.devices:
        import torch

        count = torch.cuda.device_count()
        n = count if args.devices == "all" else args.devices
        if n > count:
            raise SystemExit(
                f"--devices {n}: only {count} device(s) available"
            )
        devices = [f"cuda:{i}" for i in range(n)]
        print(f"frame-parallel across {len(devices)} device(s)")
    print(f"rendering '{path.name}': {job.total_frames()} frames "
          f"@ {args.width}x{args.height}")
    stats = job.run(devices=devices, progress=lambda k, n, ms: print(
        f"\r  frame {k}/{n} ({ms:.0f} ms)", end="", flush=True))
    print(f"\n{stats}")


def cmd_interactive(args):
    from relativisticraytracer_tpu_torch.runtime.app import Session
    from relativisticraytracer_tpu_torch.runtime.preview import (
        PreviewServer,
        run_terminal_preview,
    )

    import pathlib

    # Interactive by default, as in the JAX package: unless the user picked
    # a size or preset explicitly, the SESSION drops to the realtime preset
    # (480x272) with motion-adaptive stepping; stills and animation keep
    # the reference default (main.cpp:482-539).
    if args.preset is None and args.width is None and args.height is None:
        args.preset = "realtime"  # _build_renderer resolves the resolution
    if args.motion_steps is None:
        # the chosen preset's default
        args.motion_steps = PRESET_MOTION_STEPS.get(args.preset, 0)

    renderer = _build_renderer(args)
    motion_r = None
    if args.motion_steps >= args.max_steps:
        args.motion_steps = 0  # no win below the session's own cap
    if args.motion_steps:
        from relativisticraytracer_tpu_torch.render.pipeline import Renderer

        import dataclasses

        # Same scene/resolution, reduced step cap — and the SAME device
        # skybox (no duplicate upload or starfield regeneration).
        motion_r = Renderer(
            renderer.scene,
            dataclasses.replace(renderer.settings,
                                max_steps=args.motion_steps),
            skybox=renderer.sky,
            device=args.device,
        )
    session = Session(renderer=renderer, motion_renderer=motion_r)
    if args.state and pathlib.Path(args.state).exists():
        if session.load_state(args.state):
            print(f"restored session state from {args.state}")

    def _save_state():
        if args.state:
            session.save_state(args.state)
            print(f"saved session state to {args.state}")

    if args.terminal:
        try:
            run_terminal_preview(session, width=args.term_width,
                                 fps_cap=args.fps_cap)
        finally:
            # Persist even when the preview dies (device error, ^C): the
            # whole point of --state is surviving imperfect exits.
            _save_state()
            session.close()
        return
    server = PreviewServer(session, host=args.host, port=args.port,
                           fps_cap=args.fps_cap)
    print(f"live preview: http://{args.host}:{server.port}  "
          "(click to capture mouse; WASD fly, R rec, P path, N next, "
          "B/V/L/C effects; Ctrl-C to quit)")
    try:
        server.serve_until_interrupt()
    finally:
        _save_state()


def cmd_paths(_args):
    from relativisticraytracer_tpu_torch.paths import default_paths

    for i, p in enumerate(default_paths()):
        dur = p.keyframes[-1].time
        print(f"[{i}] {p.name}: {len(p.keyframes)} keyframes, {dur:.0f}s")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(prog="relativisticraytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_still = sub.add_parser("still", help="render a single frame to PNG")
    _add_render_args(p_still)
    p_still.add_argument("--out", default="frame.png")
    p_still.add_argument("--cam-x", type=float, default=0.0)
    p_still.add_argument("--cam-y", type=float, default=10.0)
    p_still.add_argument("--cam-z", type=float, default=-60.0)
    p_still.add_argument("--yaw", type=float, default=0.0)
    p_still.add_argument("--pitch", type=float, default=-10.0)
    p_still.set_defaults(fn=cmd_still)

    p_anim = sub.add_parser("anim", help="render a camera path to video")
    _add_render_args(p_anim)
    p_anim.add_argument("--path-index", type=int, default=0)
    p_anim.add_argument("--fps", type=int, default=24)
    p_anim.add_argument("--duration", type=float, default=None)
    p_anim.add_argument("--out", default=None,
                        help="output target: .mp4 (needs ffmpeg; falls back "
                             "to raw .rgba + sidecar), or a directory / "
                             "trailing-slash path for a resumable PNG "
                             "frame sequence")
    p_anim.add_argument("--transfer", default="rgba",
                        choices=["rgba", "yuv420p"],
                        help="device->host frame format: yuv420p converts "
                             "on the device (1.5 B/px vs 4 - 2.67x less link "
                             "bandwidth; FFmpeg takes it directly). "
                             "rgba is the reference layout; PNG-sequence "
                             "targets require rgba")
    p_anim.add_argument("--devices", default=None, type=_devices_arg,
                        help="'all' or a count N: render whole frames "
                             "round-robin across that many CUDA cards "
                             "(no communication between them)")
    p_anim.set_defaults(fn=cmd_anim)

    p_live = sub.add_parser(
        "interactive",
        help="live fly-camera preview (MJPEG over HTTP, or --terminal)",
    )
    _add_render_args(p_live)
    p_live.add_argument("--host", default="127.0.0.1")
    p_live.add_argument("--port", type=int, default=8000)
    p_live.add_argument("--fps-cap", type=float, default=30.0)
    p_live.add_argument("--terminal", action="store_true",
                        help="render to the terminal (ANSI half-blocks)")
    p_live.add_argument("--term-width", type=int, default=100)
    p_live.add_argument("--state", default=None,
                        help="JSON file to restore/persist the session "
                             "(pose, clock, effects, path) across runs")
    p_live.add_argument("--motion-steps", type=int, default=None,
                        help="while actively flying, march with this "
                             "reduced step cap for a snappier preview "
                             "(full quality returns when you stop; "
                             "recording always renders full quality); "
                             "0 disables. Default: the preset's "
                             "cap (realtime 600, native 400), 0 for "
                             "other sizes; with no "
                             "size/preset at all, the realtime preset is "
                             "used")
    p_live.set_defaults(fn=cmd_interactive)

    p_paths = sub.add_parser("paths", help="list built-in camera paths")
    p_paths.set_defaults(fn=cmd_paths)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
