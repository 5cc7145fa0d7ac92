"""Host application runtime: the headless replacement for the reference's
GLFW/OpenGL main loop (src/main.cpp:482-539).

There is no window on an accelerator host; the interactive surface is a headless
`Session` with the exact same controls and clock semantics (key handling
per key_callback main.cpp:270-306, fixed-step recording clock per
main.cpp:505-529), plus an offline `AnimationJob` that renders a camera
path to video — frame-indexed and resumable (every frame is a pure
function of (path, frame_index), SURVEY.md §5)."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import threading
import time as _time
from typing import Callable, Optional

import numpy as np

from relativisticraytracer_tpu.config import (
    RECORDING_FPS,
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu.io.video import VideoRecorder
from relativisticraytracer_tpu.paths import (
    CameraController,
    CameraPath,
    PathController,
    PathManager,
    fixed_step_dt,
    init_default_paths,
    interpolate_path,
)
from relativisticraytracer_tpu.render.camera import camera_state_from_pose
from relativisticraytracer_tpu.render.pipeline import Renderer

log = logging.getLogger("relativisticraytracer_tpu")

_yuv_jit = None


def _yuv_convert(frame):
    """On-device RGBA->planar YUV420 (jitted once; follows the frame's
    device, so frame-parallel multi-card animation converts per card)."""
    global _yuv_jit
    if _yuv_jit is None:
        import jax

        from relativisticraytracer_tpu.render.postfx import yuv420_from_rgba8

        _yuv_jit = jax.jit(yuv420_from_rgba8)
    return _yuv_jit(frame)


class Session:
    """Headless interactive session: fly camera + paths + effects + recorder
    wired exactly like the reference app (minus the OS window).

    handle_key: 'r' record toggle, 'p' path toggle, 'n' next path,
    'b'/'v'/'l'/'c' effect toggles (main.cpp:270-306);
    'w','a','s','d','space','shift' move the fly camera (main.cpp:329-357).
    """

    def __init__(self, renderer: Optional[Renderer] = None,
                 scene: SceneConfig = SceneConfig(),
                 settings: RenderSettings = RenderSettings(),
                 skybox_rgba: Optional[np.ndarray] = None,
                 motion_renderer: Optional[Renderer] = None,
                 motion_hold_s: float = 0.4):
        self.renderer = renderer or Renderer(scene, settings, skybox_rgba=skybox_rgba)
        # Motion-adaptive preview quality (beyond the reference): while the
        # user is actively flying/looking, frames render with this cheaper
        # renderer (same resolution, typically a reduced step cap) and snap
        # back to full quality `motion_hold_s` after the last input.
        # Recording is ALWAYS full quality — captured frames keep exact
        # reference semantics.
        self.motion_renderer = motion_renderer
        self.motion_hold_s = motion_hold_s
        self._last_input = float("-inf")
        self.camera = CameraController()
        self.paths = PathController(manager=init_default_paths(PathManager()))
        self.effects = CameraEffects()
        self.recorder = VideoRecorder(
            self.renderer.settings.width, self.renderer.settings.height
        )
        # The preview server toggles recording from HTTP handler threads
        # while tick() runs on the render thread; the toggle and the
        # is_recording+capture pair must be atomic or a mid-frame stop
        # crashes capture() and kills the render loop.
        self._rec_lock = threading.Lock()
        # ESC requests shutdown, like the reference's window-close path
        # (main.cpp:303-305); the host loop (PreviewServer / terminal
        # preview / CLI) observes this and tears down via close().
        self.quit_requested = False
        self.sim_time = 0.0
        self.frame_count = 0
        self._fps_clock = _time.perf_counter()
        self._fps_frames = 0
        self.fps = 0.0

    # --- input (key_callback, main.cpp:270-306) ---
    def handle_key(self, key: str) -> None:
        key = key.lower()
        if key == "r":
            with self._rec_lock:
                self.recorder.toggle()
        elif key == "p":
            if self.paths.active:
                self.paths.stop()
            else:
                self.paths.start()
        elif key == "n":
            self.paths.next_path()
        elif key == "b":
            on = float(self.effects.use_bloom) <= 0.5
            self.effects = self.effects.replace(use_bloom=1.0 if on else 0.0)
        elif key == "v":
            on = float(self.effects.use_vignette) <= 0.5
            self.effects = self.effects.replace(use_vignette=1.0 if on else 0.0)
        elif key == "l":
            on = float(self.effects.use_lens_distortion) <= 0.5
            self.effects = self.effects.replace(
                use_lens_distortion=1.0 if on else 0.0
            )
        elif key == "c":
            on = float(self.effects.use_chromatic_aberration) <= 0.5
            self.effects = self.effects.replace(
                use_chromatic_aberration=1.0 if on else 0.0
            )
        elif key in ("escape", "esc"):
            # ESC -> quit (key_callback, main.cpp:303-305). The recorder is
            # stopped by close(), mirroring the reference's post-loop
            # cleanup (main.cpp:531-532), not here.
            self.quit_requested = True
        elif key in ("w", "a", "s", "d", "space", "shift"):
            self.camera.move(key)
            self._last_input = _time.perf_counter()

    def mouse(self, dx: float, dy: float) -> None:
        self.camera.look(dx, dy)
        self._last_input = _time.perf_counter()

    # --- frame loop (main.cpp:505-529) ---
    def tick(self, wall_dt: float) -> np.ndarray:
        """Advance the sim clock and render one frame. While recording, dt is
        pinned to 1/RECORDING_FPS (main.cpp:511-513)."""
        # Snapshot the recording flag under the lock ONCE: both the sim
        # clock and the renderer choice must agree with what capture sees,
        # or an HTTP-thread R-toggle between the check and the capture
        # could record a reduced-quality motion frame.
        with self._rec_lock:
            recording = self.recorder.is_recording
        dt = fixed_step_dt(recording, wall_dt)
        self.sim_time += dt
        self.paths.update(dt)
        cam = (
            self.paths.interpolated_state(self.camera)
            if self.paths.active
            else self.camera.state()
        )
        r = self.renderer
        used_motion = False
        if (
            self.motion_renderer is not None
            and not recording
            and _time.perf_counter() - self._last_input < self.motion_hold_s
        ):
            r = self.motion_renderer
            used_motion = True
        frame = r.render_np(cam, self.effects, self.sim_time)
        with self._rec_lock:
            # Capture only if recording was ALREADY on at the clock
            # snapshot: a mid-tick R-toggle starts recording on the NEXT
            # tick, whose dt is pinned to 1/RECORDING_FPS — so the
            # recorded stream never contains a reduced-step motion frame
            # NOR a frame whose sim step was wall-clock sized
            # (main.cpp:511-513 semantics).
            if recording and self.recorder.is_recording:
                assert not used_motion
                self.recorder.capture(frame)
        self.frame_count += 1
        self._fps_frames += 1
        now = _time.perf_counter()
        if now - self._fps_clock >= 1.0:  # 1 Hz meter (updateFPS, main.cpp:438-458)
            self.fps = self._fps_frames / (now - self._fps_clock)
            self._fps_clock = now
            self._fps_frames = 0
        return frame

    def status(self) -> str:
        """The reference's title-bar line (main.cpp:452-453)."""
        rec = " [REC]" if self.recorder.is_recording else ""
        pth = " [PATH]" if self.paths.active else ""
        path = self.paths.manager.get_path(self.paths.current_path_index)
        name = path.name if path else "None"
        return (
            f"Relativistic Ray Tracer | FPS: {self.fps:.1f} |{rec}{pth} "
            f"{name} | R:Rec P:Path N:Next"
        )

    # --- state persistence (beyond the reference, which loses the pose on
    # exit; pairs with AnimationJob's frame checkpointing for a fully
    # resumable workflow) ---
    def save_state(self, path: str) -> None:
        """Persist pose/clock/effects/path selection to JSON."""
        state = {
            "pos": [float(v) for v in self.camera.pos],
            "yaw": float(self.camera.yaw),
            "pitch": float(self.camera.pitch),
            "sim_time": self.sim_time,
            "path_index": self.paths.current_path_index,
            "path_active": self.paths.active,
            "path_time": self.paths.path_time,
            "effects": {
                f.name: float(getattr(self.effects, f.name))
                for f in dataclasses.fields(self.effects)
            },
        }
        # Atomic: a kill mid-write must not leave a truncated file that
        # breaks every subsequent --state launch.
        target = pathlib.Path(path)
        tmp = target.with_name(target.name + ".tmp")
        tmp.write_text(json.dumps(state, indent=2))
        os.replace(tmp, target)

    def load_state(self, path: str) -> bool:
        """Restore pose/clock/effects/path from JSON written by save_state.

        Returns True on success. A truncated or version-incompatible file
        logs a warning and leaves the session at defaults (False) — a stale
        state file must never make the app unlaunchable."""
        try:
            state = json.loads(pathlib.Path(path).read_text())
            pos = np.array(state["pos"], dtype=np.float32)
            yaw, pitch = state["yaw"], state["pitch"]
            sim_time = state["sim_time"]
            path_index = state["path_index"]
            path_active, path_time = state["path_active"], state["path_time"]
            effects = CameraEffects(**state["effects"])
        except Exception as e:  # noqa: BLE001 — any corrupt file is non-fatal
            log.warning("ignoring unreadable session state %s: %s", path, e)
            return False
        self.camera.pos = pos
        self.camera.yaw = yaw
        self.camera.pitch = pitch
        self.sim_time = sim_time
        self.paths.current_path_index = path_index
        self.paths.active = path_active
        self.paths.path_time = path_time
        self.effects = effects
        return True

    def close(self) -> None:
        self.recorder.stop()


@dataclasses.dataclass
class AnimationJob:
    """Offline path-to-video render with checkpoint/resume, pipelined
    dispatch, and optional frame-parallel multi-card rendering.

    Frames are indexed on the fixed-step clock (frame k <-> t = k/fps,
    reference: main.cpp:511-515), so every frame is a pure function of
    (path, k) and a killed job resumes at the first unwritten frame:
      * raw-file sink (no ffmpeg): the file appends in place;
      * MP4 sink: segment encoding (io/video.SegmentedRecorder) — one
        finalized MP4 per checkpoint interval, losslessly concatenated at
        the end, so encoder state survives a kill too;
      * directory out_path: PNG frame sequence (io/image.
        FrameSequenceWriter) — encoder-free, each finished file is its
        own checkpoint.

    Dispatch is double-buffered: up to `inflight` frames are in flight on
    the device(s) while the host fetches/encodes earlier ones, hiding the
    per-call host<->device latency (the reference's recording loop is
    likewise throughput-bound, main.cpp:505-529). With `devices=[...]`,
    frames round-robin across cards — zero communication, linear scaling —
    the frame-parallel complement to parallel/sharding's spatial tiling.
    """

    path: CameraPath
    renderer: Renderer
    effects: CameraEffects = dataclasses.field(default_factory=CameraEffects)
    fps: int = RECORDING_FPS
    duration: Optional[float] = None  # default: last keyframe time
    out_path: Optional[str] = None
    checkpoint_every: int = 24
    # Device->host transfer format: "rgba" (uint8[H,W,4], reference layout)
    # or "yuv420p" — frames are converted ON DEVICE
    # (render/postfx.yuv420_from_rgba8) to 1.5 B/px planar YUV before the
    # fetch, a 2.67x link-bandwidth cut for bandwidth-bound links; the
    # video sinks feed it straight to FFmpeg (-pix_fmt yuv420p rawvideo),
    # which skips its swscale pass. Not valid for PNG-sequence targets.
    transfer: str = "rgba"

    def _checkpoint_path(self, out_path: str) -> pathlib.Path:
        return pathlib.Path(out_path + ".ckpt.json")

    def total_frames(self) -> int:
        duration = (
            self.duration
            if self.duration is not None
            else self.path.keyframes[-1].time
        )
        return int(round(duration * self.fps))

    def _open_writer(self, resume: bool):
        """Pick the sink and resolve the resume point. Returns
        (capture, on_frame_done, finalize, abort, out_path, start_frame)."""
        from relativisticraytracer_tpu.io.video import (
            SegmentedRecorder,
            ffmpeg_available,
        )

        settings = self.renderer.settings
        if self.out_path is not None and (
            self.out_path.endswith(("/", os.sep))
            or pathlib.Path(self.out_path).is_dir()
        ):
            # Directory target -> PNG frame sequence (encoder-free; each
            # finished file is its own checkpoint).
            from relativisticraytracer_tpu.io.image import FrameSequenceWriter

            if self.transfer != "rgba":
                raise ValueError(
                    "PNG frame-sequence targets need transfer='rgba' "
                    f"(got {self.transfer!r})"
                )
            seq = FrameSequenceWriter(self.out_path, settings.width,
                                      settings.height, fps=self.fps)
            if not resume:
                # Fresh run: clear leftover frames BEFORE resume() — its
                # geometry guard must only veto actual resumes, not a
                # re-render of the same directory at a new resolution.
                seq.dir.mkdir(parents=True, exist_ok=True)
                for f in seq.dir.glob("frame_*.png"):
                    f.unlink()
            start_frame = seq.resume()
            if resume:
                # A prior run with a longer duration / higher fps may have
                # left frames beyond this run's count; drop them so the
                # directory holds exactly the advertised sequence.
                start_frame = seq.truncate_to(self.total_frames())
            return (seq.capture, lambda k: None, seq.stop, seq.abort,
                    self.out_path, start_frame)

        if ffmpeg_available() and self.out_path is not None:
            seg = SegmentedRecorder(
                settings.width, settings.height, self.fps,
                out_path=self.out_path,
                segment_frames=self.checkpoint_every,
                pix_fmt=self.transfer,
            )
            start_frame = seg.resume() if resume else 0
            if resume:
                # A prior run with a longer duration / higher fps may have
                # checkpointed segments beyond this run's frame count —
                # drop them (a straddling segment re-renders) so the final
                # video holds exactly the advertised frames.
                start_frame = seg.truncate_to(self.total_frames())
            if not resume:
                # discard any stale checkpoint/segments from a prior run
                import shutil as _shutil

                _shutil.rmtree(seg.seg_dir, ignore_errors=True)
                if seg._ckpt.exists():
                    seg._ckpt.unlink()
            return (seg.capture, lambda k: None, seg.stop, seg.abort,
                    self.out_path, start_frame)

        rec = VideoRecorder(settings.width, settings.height, self.fps,
                            out_path=self.out_path, pix_fmt=self.transfer)
        # Resolve the resume point BEFORE opening the sink so raw-file mode
        # appends at the right frame instead of truncating finished work.
        start_frame = 0
        if resume and rec.raw_fallback and self.out_path is not None:
            from relativisticraytracer_tpu.io.video import raw_extension

            raw_path = pathlib.Path(self.out_path).with_suffix(
                "." + raw_extension(self.transfer))
            ckpt_probe = self._checkpoint_path(str(raw_path))
            if ckpt_probe.exists():
                start_frame = json.loads(ckpt_probe.read_text()).get("next_frame", 0)
                # The checkpoint records frames SUBMITTED to the async sink;
                # the file is the source of truth for frames actually flushed
                # (a crash can lose queued frames). Resume from whichever is
                # smaller, never past the on-disk whole-frame count.
                frame_bytes = rec.frame_bytes
                on_disk = (
                    raw_path.stat().st_size // frame_bytes
                    if raw_path.exists()
                    else 0
                )
                # ...and never past this run's frame count: a shorter
                # re-run must not keep a longer prior run's tail (start()
                # truncates the raw file to append_frames frames).
                start_frame = min(start_frame, on_disk, self.total_frames())
        out_path = rec.start(append_frames=start_frame)
        ckpt = self._checkpoint_path(out_path)

        def on_frame_done(k_next: int) -> None:
            if k_next % self.checkpoint_every == 0:
                ckpt.write_text(json.dumps({"next_frame": k_next,
                                            "out_path": out_path}))

        def finalize() -> int:
            written = rec.stop()
            if ckpt.exists():
                ckpt.unlink()
            return written

        return (rec.capture, on_frame_done, finalize, rec.stop, out_path,
                start_frame)

    def run(self, resume: bool = True,
            progress: Optional[Callable[[int, int, float], None]] = None,
            devices: Optional[list] = None,
            inflight: Optional[int] = None) -> dict:
        import collections

        capture, on_frame_done, finalize, abort, out_path, start_frame = (
            self._open_writer(resume)
        )
        devices = list(devices) if devices else [None]
        depth = max(1, inflight) if inflight is not None else max(4, 2 * len(devices))

        n = self.total_frames()
        t_start = _time.perf_counter()
        frame_ms = []
        # Two-stage pipeline on one thread, FIFO so frames stay in order:
        # dispatch render k, start its device->host copy immediately
        # (`copy_to_host_async`), and drain frame k-depth to the sink — by
        # then its copy has landed, so np.asarray is a cheap host memcpy.
        # The reference's loop overlaps render with encode the same way via
        # its async sink (main.cpp:505-529). How much of the transfer and
        # encode this hides on the GPU is not measured yet (ROADMAP S5).
        pending = collections.deque()   # (k, device frame) — copy already started
        last_done = t_start

        def encode_one():
            nonlocal last_done
            k, dev_frame = pending.popleft()
            capture(np.asarray(dev_frame))
            now = _time.perf_counter()
            frame_ms.append((now - last_done) * 1000.0)
            last_done = now
            if progress is not None:
                progress(k + 1, n, frame_ms[-1])
            on_frame_done(k + 1)

        try:
            for k in range(start_frame, n):
                t = (k + 1) / self.fps  # clock accumulates BEFORE render (main.cpp:515)
                pos, yaw, pitch = interpolate_path(self.path, t)
                cam = camera_state_from_pose(pos, yaw, pitch)
                dev_frame = self.renderer.render_on(
                    devices[(k - start_frame) % len(devices)],
                    cam, self.effects, t,
                )
                if self.transfer == "yuv420p":
                    dev_frame = _yuv_convert(dev_frame)
                dev_frame.copy_to_host_async()
                pending.append((k, dev_frame))
                # Drain down to depth-1 so at most `depth` frames (the
                # documented `inflight` bound) are ever device-resident.
                while len(pending) >= depth:
                    encode_one()
            while pending:
                encode_one()
        except BaseException:
            # Best-effort flush so the checkpoint reflects every frame that
            # made it to the sink — the next run(resume=True) continues here.
            import contextlib

            with contextlib.suppress(Exception):
                abort()
            raise
        written = finalize()
        wall = _time.perf_counter() - t_start
        stats = {
            "out_path": out_path,
            "frames": n - start_frame,
            "frames_written": written,
            "resumed_at": start_frame,
            "wall_s": wall,
            "devices": len(devices),
            "mean_frame_ms": (
                wall * 1000.0 / (n - start_frame) if n > start_frame else 0.0
            ),
        }
        log.info("animation done: %s", stats)
        return stats
