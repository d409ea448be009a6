"""Key-driven interactive frame loop — the reference's L4 controls.

Behavioral spec: every reference demo polls the keyboard between
steps_per_frame batches — pause/reset/view-mode cycling
(tau_hypersonic_cuda.cu:1825-1831), live parameter nudges that re-derive
dependent state (tau_sph.cu:622-657: h / c0 / dTau rebuilding the cell
grid), obstacle toggles re-initializing the field (tau_lbm.cu:281-286).

Port of fluidsims_tpu.core.interactive (standard library only): a
raw-mode stdin poll plays the role of the ncurses/raylib event loop over
streamed terminal frames.  Parameter nudges call `ctx.invalidate()`,
which rebuilds the runner from the (updated) config, the analog of the
reference re-deriving cfg-dependent device state; the port's runners are
plain Python functions, so a rebuild compiles nothing.

The loop is fully injectable (scripted key source, frame sink, bounded
step count) so the interactive contract is unit-testable without a TTY.
"""

from __future__ import annotations

import sys
import time

__all__ = ["Context", "RawStdin", "interactive_loop"]


class Context:
    """Mutable loop state handed to key handlers."""

    def __init__(self, state, stride: int = 1):
        self.state = state
        self.paused = False
        self.step_once = False
        self.quit = False
        self.needs_rebuild = False
        self.frames = 0
        self.steps_done = 0
        # steps per rendered frame; handlers may halve/double it live
        # (the reference's +/- publish-stride keys, number_fluid2d.c:814-820)
        self.stride = stride

    def invalidate(self):
        """Request a runner rebuild (after a config nudge)."""
        self.needs_rebuild = True


class RawStdin:
    """Non-blocking single-character reads from a raw-mode terminal;
    degrades to a silent no-op when stdin is not a tty.

    Signal traps (the js_cuda.cu:284-292 cleanup analog): while raw mode
    is active, SIGTERM/SIGHUP restore the terminal and exit with the
    conventional 128+signum status — a plain `kill` would otherwise
    terminate the process without unwinding the `with` block and leave
    the terminal in cbreak mode.  (SIGINT already unwinds through
    KeyboardInterrupt, which __exit__ handles.)"""

    _TRAPPED = ("SIGTERM", "SIGHUP")

    def __init__(self):
        self._active = False
        self._old = None
        self._prev_handlers = {}

    def _restore(self):
        if self._active:
            self._termios.tcsetattr(self._fd, self._termios.TCSADRAIN,
                                    self._old)
            self._active = False

    def _on_signal(self, signum, frame):
        self._restore()
        raise SystemExit(128 + signum)

    def __enter__(self):
        try:
            import termios
            import tty

            if sys.stdin.isatty():
                self._fd = sys.stdin.fileno()
                self._old = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                self._termios = termios
                self._active = True
        except Exception:
            self._active = False
        if self._active:
            try:
                import signal

                for name in self._TRAPPED:
                    sig = getattr(signal, name, None)
                    if sig is not None:
                        self._prev_handlers[sig] = signal.signal(
                            sig, self._on_signal)
            except (ValueError, OSError):
                pass  # non-main thread: no traps, restore-on-exit only
        return self

    def __exit__(self, *exc):
        self._restore()
        if self._prev_handlers:
            import signal

            for sig, prev in self._prev_handlers.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._prev_handlers = {}
        return False

    def pending(self) -> str:
        """All currently buffered key characters (possibly empty)."""
        if not self._active:
            return ""
        import os
        import select

        chars = []
        while select.select([self._fd], [], [], 0)[0]:
            chars.append(os.read(self._fd, 1).decode(errors="ignore"))
        return "".join(chars)


def interactive_loop(state, make_runner, frame_fn, keys, stride: int = 1,
                     max_steps: int | None = None, status_fn=None,
                     input_fn=None, out=None, fps_cap: float = 60.0):
    """Run the interactive frame loop.

    state        initial solver state
    make_runner  () -> callable(state, n_steps) -> state; re-invoked after
                 a handler calls ctx.invalidate()
    frame_fn     (state) -> str terminal frame
    keys         {char: (label, handler)}; handler(ctx) mutates ctx/state.
                 'q' (quit) is built in.
    stride       physics steps per rendered frame (steps_per_frame)
    max_steps    stop after this many physics steps (None = until 'q')
    status_fn    (ctx) -> str extra HUD text
    input_fn     () -> str of pending keys (default: raw-mode stdin)
    out          writable (default sys.stdout)
    """
    out = out or sys.stdout
    ctx = Context(state, stride=stride)
    runner = make_runner()
    help_line = " ".join(
        ["[q]uit"] + [f"[{k if k != ' ' else 'spc'}]{label}"
                      for k, (label, _) in keys.items()])

    raw = RawStdin() if input_fn is None else None
    get_keys = input_fn if input_fn is not None else raw.pending
    first = True
    last_frame_t = 0.0

    def body():
        nonlocal runner, first, last_frame_t
        while not ctx.quit and (max_steps is None
                                or ctx.steps_done < max_steps):
            for ch in get_keys():
                if ch == "q":
                    ctx.quit = True
                elif ch in keys:
                    keys[ch][1](ctx)
            if ctx.quit:
                break
            if ctx.needs_rebuild:
                print("rebuilding runner (config changed)...",
                      file=sys.stderr)
                runner = make_runner()
                ctx.needs_rebuild = False

            advanced = False
            if not ctx.paused or ctx.step_once:
                ctx.state = runner(ctx.state, ctx.stride)
                ctx.steps_done += ctx.stride
                ctx.step_once = False
                advanced = True

            frame = frame_fn(ctx.state)
            status = status_fn(ctx) if status_fn else ""
            pause_tag = " [PAUSED]" if ctx.paused else ""
            text = (f"{frame}\n"
                    f"step {ctx.steps_done}{pause_tag}  {status}\n"
                    f"{help_line}")
            if not first:
                out.write(f"\x1b[{text.count(chr(10)) + 1}A\r")
            first = False
            out.write(text + "\n")
            if hasattr(out, "flush"):
                out.flush()
            ctx.frames += 1

            if not advanced:
                time.sleep(0.05)  # paused: don't spin
            elif fps_cap > 0:
                now = time.perf_counter()
                wait = (1.0 / fps_cap) - (now - last_frame_t)
                if wait > 0:
                    time.sleep(wait)
                last_frame_t = time.perf_counter()

    if raw is not None:
        with raw:
            body()
    else:
        body()
    return ctx.state
