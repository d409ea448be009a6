"""Port vs JAX: the CLI's driver surface on every solver subcommand.

`--render --stride`, `--png` (with and without `--stride`), `--interactive`
with a scripted key source and with a non-tty stdin, as the JAX twins in
tests/test_render.py, tests/test_cli_smoke.py and
tests/test_interactive.py:78 run them; the `--png` warning where a solver
has no RGB export; the frames and PNGs of both CLIs on one f64 state that
JAX's CLI stepped and saved and both CLIs load (`--load-state --steps 0
--render --png`): the frame strings equal, the PNGs equal or within one
level where the colours come from a device computation that rounds
otherwise.
"""

import struct
import warnings

import numpy as np
import pytest
import torch

from fluidsims_tpu_torch import cli

torch.set_num_threads(1)

# subcommand -> (flags of both CLIs, JAX-only flags, port-only flags,
#                JAX steps before the frame, rows of a frame, RGB export)
CASES = {
    "gray-scott": (["--nx", "32", "--ny", "16"], [], [], 40, 16, True),
    "burgers": (["--nx", "32", "--ny", "24"], [], [], 4, 24, True),
    "shallow-water": (["--nx", "32", "--ny", "24"], [], [], 4, 24, True),
    "lbm": (["--nx", "32", "--ny", "16", "--radius", "4"], [], [], 30, 16,
            True),
    "hypersonic2d": (["--nx", "64", "--ny", "32"], ["--impl", "xla"],
                     ["--impl", "torch"], 12, 32, True),
    "hypersonic3d": (["--n", "12"], ["--impl", "xla"], ["--impl", "torch"],
                     3, 12, False),
    "mhd": (["--nx", "32", "--ny", "24", "--case", "orszag-tang"], [], [],
            6, 24, True),
    "stam2d": (["--n", "16"], ["--engine", "xla"], [], 5, 16, True),
    "stam3d": (["--n", "12", "--cols", "30", "--rows", "10"], [], [], 3,
               10, False),
    "sph": (["--n", "256", "--cols", "30", "--rows", "10"],
            ["--engine", "exact"], ["--engine", "exact"], 3, 10, False),
    "flip": (["--particles", "256", "--grid", "16"], ["--engine", "scatter"],
             ["--engine", "scatter"], 3, 16, False),
    "mpm": (["--n", "256", "--gx", "32", "--gy", "32", "--cols", "30",
             "--rows", "10"], ["--engine", "scatter"], ["--engine", "scatter"],
            3, 10, False),
}


def port_argv(cmd, *extra):
    flags, _, port_only, *_ = CASES[cmd]
    return [cmd, *flags, *port_only, "--device", "cpu", *extra]


def ihdr(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", data[16:24])


def png_pixels(path):
    import zlib

    data = path.read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    ch = {2: 3, 6: 4}[data[25]]
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:
                               data.index(b"IEND") - 4])
    return np.frombuffer(raw, np.uint8).reshape(h, 1 + w * ch)[:, 1:]


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_render_stride_live_frames(capsys, cmd):
    assert cli.main(port_argv(cmd, "--render", "--stride", "2", "--steps",
                              "4")) == 0
    out = capsys.readouterr().out
    name = {"flip": "flip-apic"}.get(cmd, cmd)
    assert f"[{name}] step 2/4" in out and f"[{name}] step 4/4" in out
    assert "\x1b[" in out              # the second frame redraws the first
    assert "4 steps in" in out         # then the report line


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_png_final_and_strided(tmp_path, capsys, cmd):
    *_, rows, rgb = CASES[cmd]
    final = tmp_path / "f.png"
    assert cli.main(port_argv(cmd, "--steps", "2", "--png",
                              str(final))) == 0
    seq = tmp_path / "s.png"
    assert cli.main(port_argv(cmd, "--steps", "4", "--stride", "2", "--png",
                              str(seq))) == 0
    captured = capsys.readouterr()
    if not rgb:
        assert "no effect" in captured.err
        assert not list(tmp_path.iterdir())
        return
    assert f"wrote {final}" in captured.out
    w, h = ihdr(final)
    assert h == rows
    for i in (0, 1):
        assert ihdr(tmp_path / f"s_{i:04d}.png") == (w, h)
    assert not (tmp_path / "s_0002.png").exists()


# the interactive keys of each subcommand, as JAX's CLI binds them; each
# pause toggle twice, so that the run goes on
KEYS = {
    "gray-scott": "FfKkpp r",
    "burgers": "mmmpp r",
    "shallow-water": "mmpp r",
    "lbm": "+-o  ",
    "hypersonic2d": "mmmmmmmr  ",
    "hypersonic3d": "ml-=[]pp r",
    "mhd": "mmmmcpp r",
    "stam2d": "pp r",
    "stam3d": "pp r",
    "sph": "gv=-][><pp r",
    "flip": "fFaApp r",
    "mpm": "mmpp r",
}


def scripted(keys, limit=200):
    """A key source that gives `keys` one a call, then none, and quits
    after `limit` calls (a loop that stops stepping cannot hang)."""
    script = iter(["", *keys])
    calls = [0]

    def keys_fn():
        calls[0] += 1
        return next(script, "") if calls[0] < limit else "q"

    return keys_fn


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_interactive_scripted_keys(capsys, cmd):
    """Each key of the subcommand once, then the steps run out."""
    args = cli.build_parser().parse_args(
        port_argv(cmd, "--interactive", "--stride", "1", "--steps",
                  str(len(KEYS[cmd]) + 2)))
    args.input_fn = scripted(KEYS[cmd])
    final = args.fn(args)
    out = capsys.readouterr().out
    assert ": interactive ([q] quits)" in out and "device=cpu" in out
    assert "[q]uit" in out
    for k in set(KEYS[cmd]):
        assert f"[{'spc' if k == ' ' else k}]" in out
    assert final is not None


def test_interactive_status_lines(capsys):
    """The nudges and cycles show in the status line."""
    args = cli.build_parser().parse_args(
        port_argv("gray-scott", "--interactive", "--stride", "1", "--steps",
                  "3"))
    args.input_fn = scripted("FK")
    args.fn(args)
    out = capsys.readouterr().out
    assert "F=0.0310 k=0.0605" in out
    args = cli.build_parser().parse_args(
        port_argv("hypersonic2d", "--interactive", "--stride", "1",
                  "--steps", "2"))
    args.input_fn = scripted("m")
    args.fn(args)
    assert "view=vorticity" in capsys.readouterr().out
    args = cli.build_parser().parse_args(
        port_argv("mhd", "--interactive", "--stride", "1", "--steps", "2"))
    args.input_fn = scripted("c")
    args.fn(args)
    out = capsys.readouterr().out
    assert "problem=briowu" in out and "view=rho" in out


@pytest.mark.parametrize("cmd", ["sph", "lbm", "hypersonic2d"])
def test_interactive_non_tty(capsys, cmd):
    """As tests/test_interactive.py:78: a non-tty stdin gives no keys, and
    the loop runs to --steps."""
    assert cli.main(port_argv(cmd, "--steps", "4", "--stride", "2",
                              "--interactive")) == 0
    out = capsys.readouterr().out
    assert "step 4" in out
    assert {"sph": "[>]dTau+", "lbm": "[o]obstacle",
            "hypersonic2d": "[m]view"}[cmd] in out


def test_gray_scott_sizes_to_the_terminal_only_when_rendering(capsys):
    assert cli.main(["gray-scott", "--device", "cpu", "--steps", "1"]) == 0
    assert "gray-scott 128x128 " in capsys.readouterr().out
    args = cli.build_parser().parse_args(["gray-scott"])
    assert (args.nx, args.ny) == (0, 0)
    assert cli._terminal_auto_size(0, 0, True, halfblocks=True)[1] % 2 == 0
    assert cli._terminal_auto_size(40, 20, True) == (40, 20)


def test_render_colors_256_and_halfblocks(capsys):
    assert cli.main(["stam3d", "--n", "12", "--device", "cpu", "--steps",
                     "2", "--render", "--colors", "256", "--cols", "30",
                     "--rows", "12"]) == 0
    assert "\x1b[38;5;" in capsys.readouterr().out
    assert cli.main(port_argv("hypersonic2d", "--steps", "2", "--render",
                              "--colors", "256")) == 0
    assert "\x1b[38;5;" in capsys.readouterr().out
    assert cli.main(port_argv("gray-scott", "--steps", "2", "--render",
                              "--halfblocks")) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 + 8          # the report, then 16 rows as 8


def test_headless_flag_turns_frames_off(tmp_path, capsys):
    assert cli.main(port_argv("gray-scott", "--steps", "2", "--stride", "1",
                              "--render", "--headless")) == 0
    assert capsys.readouterr().out.count("\n") == 2


def test_view_choices_are_checked():
    with pytest.raises(SystemExit):
        cli.main(port_argv("hypersonic2d", "--view", "nope"))
    with pytest.raises(SystemExit):
        cli.main(port_argv("hypersonic3d", "--view", "nope"))


# ------------------------------- against JAX --------------------------------


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_frames_and_pngs_match_jax(tmp_path, capsys, cmd):
    from fluidsims_tpu.cli import main as jmain

    flags, jax_only, port_only, steps, rows, rgb = CASES[cmd]
    state = tmp_path / "s.npz"
    jmain([cmd, *flags, *jax_only, "--dtype", "float64", "--steps",
           str(steps), "--headless", "--save-state", str(state)])
    capsys.readouterr()
    show = ["--dtype", "float64", "--steps", "0", "--render",
            "--load-state", str(state)]
    jpng, tpng = tmp_path / "j.png", tmp_path / "t.png"
    jmain([cmd, *flags, *jax_only, *show, "--png", str(jpng)])
    jframe = capsys.readouterr().out.splitlines()[-rows:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the structure strings differ
        assert cli.main([cmd, *flags, *port_only, "--device", "cpu", *show,
                         "--png", str(tpng)]) == 0
    tframe = capsys.readouterr().out.splitlines()[-rows:]
    assert len(tframe) == rows
    assert tframe == jframe
    if rgb:
        a, b = png_pixels(jpng), png_pixels(tpng)
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    else:
        assert not tpng.exists()
