"""PyTorch port end to end: JPEG bytes, CLI, carried-over state, the
jax-free import, the kernel build line and the cross-framework goldens.

On the CPU the JAX package's encode_array runs its two-dispatch host path,
whose bytes the JAX suite pins equal to every device path; the port's
encode_array(device="cpu") runs the one-dispatch path with the kernels'
plain versions. Bytes must be identical."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu import cli as jax_cli
from dmmt_jpeg_encoder_tpu import tables as jax_tables
from dmmt_jpeg_encoder_tpu.io.ppm import write_ppm
from dmmt_jpeg_encoder_tpu_torch import cli as port_cli
from dmmt_jpeg_encoder_tpu_torch import tables as port_tables
from dmmt_jpeg_encoder_tpu_torch.config import config_from_jax
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from torch_port_fixtures import FIXTURES, SMALL_FIXTURES, fixture_pixels, golden_entry, load_goldens

REPO = Path(__file__).resolve().parent.parent


def _image(seed, shape, maxval=255):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = 30 + (xx * 170) // max(shape[1] - 1, 1) + (yy * 40) // max(shape[0] - 1, 1)
    px = np.clip(base[..., None] + rng.integers(-20, 21, (*shape, 3)), 0, 255)
    if maxval > 255:
        px = px * 16 + rng.integers(0, 16, (*shape, 3))
        return px.astype(np.uint16)
    return px.astype(np.uint8)


BYTE_CASES = [
    ("P420", (7, 17), 255, None, "Specification"),
    ("P422", (7, 17), 255, 50, "Specification"),
    ("P444", (7, 17), 255, None, "Flat"),
    ("P420", (333, 1001), 255, 50, "MSSIM-Kodak-Tuned"),
    ("P422", (333, 1001), 255, None, "Flat"),
    ("P444", (333, 1001), 255, 50, "Specification"),
    ("P420", (61, 93), 4095, None, "Specification"),
    ("P422", (61, 93), 4095, 50, "PSNR-HVS-N-Kodak-Tuned"),
    ("P444", (61, 93), 4095, None, "DCTune-Perceptual-Optimization"),
]


@pytest.mark.parametrize("preset,shape,maxval,quality,qtable", BYTE_CASES)
def test_encode_array_bytes_match_jax(preset, shape, maxval, quality, qtable):
    px = _image(shape[0] + maxval, shape, maxval)
    cfg = dj.EncoderConfig(
        chroma_subsampling=dj.ChromaSubsamplingPreset(preset),
        quantization_preset=dj.QuantizationTablePreset(qtable),
        quality=quality,
    )
    want = dj.encode_array(px, maxval, cfg)
    got = dt.encode_array(px, maxval, config_from_jax(cfg), device="cpu")
    assert got == want


def test_encode_ppm_bytes_and_file_api(tmp_path):
    px = _image(4, (24, 40))
    src = tmp_path / "in.ppm"
    write_ppm(src, px)
    want = dj.encode_ppm_bytes(src.read_bytes())
    assert dt.encode_ppm_bytes(src.read_bytes(), device="cpu") == want
    out = tmp_path / "out.jpg"
    dt.convert_ppm_to_jpeg(src, out, device="cpu")
    assert out.read_bytes() == want


PPM_INPUTS = [
    b"P3\n2 2\n255\n1 2 3 4 5 6 7 8 9 10 11 12\n",
    b"P3\n# a comment\n1 1 # trailing\n7\n1 2 3\n",
    b"P3\n1 1\n65535\n65535 0 4095\n",
    b"P3\n1 1\n255\n256 0 0\n",
    b"P3\n2 2\n255\n1 2 3\n",
    b"P3\n1 1\n255\n1 2\n",
    b"P6\n1 1\n255\n1 2 3\n",
    b"",
    b"P3\nx 1\n255\n1 2 3\n",
]


@pytest.mark.parametrize("data", PPM_INPUTS)
def test_ppm_reader_matches_jax(data):
    from dmmt_jpeg_encoder_tpu.io.ppm import read_ppm_bytes as jax_read
    from dmmt_jpeg_encoder_tpu_torch.io.ppm import read_ppm_bytes as port_read

    def outcome(read):
        try:
            img = read(data)
        except Exception as e:  # the error type is part of the contract
            return type(e).__name__, str(e)
        return img.width, img.height, img.maxval, img.pixels.dtype, img.pixels.tobytes()

    assert outcome(port_read) == outcome(jax_read)


def test_cli_matches_jax_cli(tmp_path):
    src = tmp_path / "in.ppm"
    write_ppm(src, _image(5, (45, 77)))
    a, b = tmp_path / "jax.jpg", tmp_path / "port.jpg"
    flags = ["-p", "P422", "-q", "Flat", "-t", "2", "--quality", "80"]
    assert jax_cli.main([str(src), str(a), *flags]) == 0
    assert port_cli.main([str(src), str(b), *flags, "--device", "cpu"]) == 0
    assert b.read_bytes() == a.read_bytes()


@pytest.mark.parametrize("flags", [["--dct", "fused"], ["--shards", "2"], ["--no-native"],
                                   ["--scan-backend", "host"], ["--one-dispatch", "off"]])
def test_cli_refuses_unported_options(tmp_path, flags):
    src = tmp_path / "in.ppm"
    write_ppm(src, _image(6, (8, 8)))
    assert port_cli.main([str(src), str(tmp_path / "o.jpg"), *flags, "--device", "cpu"]) == 1
    assert not (tmp_path / "o.jpg").exists()


def test_cli_flags_mirror_jax():
    def flags(parser):
        return sorted(s for a in parser._actions for s in a.option_strings)

    extra = set(flags(port_cli.build_parser())) - set(flags(jax_cli.build_parser()))
    assert extra == {"--device"}
    assert set(flags(jax_cli.build_parser())) <= set(flags(port_cli.build_parser()))


def test_unported_configs_raise():
    px = _image(7, (8, 8))
    for cfg in (dt.EncoderConfig(dct_variant=dt.DCTVariant.SEPARATED),
                dt.EncoderConfig(num_shards=2), dt.EncoderConfig(scan_backend="host"),
                dt.EncoderConfig(one_dispatch="off")):
        with pytest.raises(NotImplementedError):
            dt.encode_array(px, 255, cfg, device="cpu")


@pytest.mark.parametrize("preset", list(dj.QuantizationTablePreset))
def test_quant_tables_and_config_carried_over(preset):
    for quality in (None, 1, 50, 75, 100):
        for a, b in zip(jax_tables.quantization_table_pair(preset, quality),
                        port_tables.quantization_table_pair(
                            dt.QuantizationTablePreset(preset.value), quality)):
            np.testing.assert_array_equal(a, b)
    for sub in dj.ChromaSubsamplingPreset:
        cfg = dj.EncoderConfig(chroma_subsampling=sub, quantization_preset=preset, quality=90)
        port = config_from_jax(cfg)
        assert port.chroma_subsampling.value == sub.value
        assert port.quantization_preset.value == preset.value
        assert (port.quality, port.bits_per_channel, port.num_shards) == (90, 8, 1)
    np.testing.assert_array_equal(jax_tables.ZIGZAG, port_tables.ZIGZAG)


def test_port_imports_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import dmmt_jpeg_encoder_tpu_torch as p\n"
        "px = np.arange(16 * 24 * 3, dtype=np.uint8).reshape(16, 24, 3)\n"
        "jpeg = p.encode_array(px, 255, device='cpu')\n"
        "assert jpeg[:2] == b'\\xff\\xd8' and jpeg[-2:] == b'\\xff\\xd9'\n"
        "assert p.encode_batch([px, px[::-1].copy(), px], 255, device='cpu')[::2] == [jpeg, jpeg]\n"
        "from dmmt_jpeg_encoder_tpu_torch.utils.native import load_native\n"
        "assert load_native() is not None\n"
        "bad = [m for m in sys.modules if m == 'jaxlib' or m.startswith(('jax.', 'dmmt_jpeg_encoder_tpu.'))"
        " or m == 'dmmt_jpeg_encoder_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_nvcc_command_line():
    assert [s.name for s in build.sources()] == ["block_hist.cu", "phase1.cu", "scan_pack.cu"]
    for src in build.sources():
        cmd = build.compile_command(src, Path("x.o"))
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined and "-c" in cmd
        assert "--fmad=false" in cmd and "-prec-div=true" in cmd
        assert "--use_fast_math" not in joined and "-use_fast_math" not in joined
        assert cmd[-1] == str(src)
    link = build.link_command([Path("a.o"), Path("b.o")], Path("out.so"))
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]
    assert build.library_path().parent == build.BUILD_DIR


def test_port_reads_no_file_of_the_jax_package():
    """The port keeps its own copies of what it needs: no module imports
    the JAX package, and no code names a path inside it (docstrings and
    comments may cite it)."""
    import ast

    from dmmt_jpeg_encoder_tpu_torch.utils import native

    port = REPO / "dmmt_jpeg_encoder_tpu_torch"
    assert native.PPM_SOURCE.is_file() and port in native.PPM_SOURCE.parents
    for path in port.rglob("*.py"):
        tree = ast.parse(path.read_text())
        docstrings = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body
            and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)
        }
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docstrings:
                names = [node.value] if "dmmt_jpeg_encoder_tpu" in node.value else []
            else:
                continue
            bad = [n for n in names if n.split(".")[0] == "dmmt_jpeg_encoder_tpu"
                   or "dmmt_jpeg_encoder_tpu/" in n]
            assert not bad, f"{path.relative_to(REPO)}: {bad}"


def test_goldens_file_covers_fixtures():
    goldens = load_goldens()
    assert set(goldens) == set(FIXTURES)
    for name in FIXTURES:
        assert set(goldens[name]) == {"pixels_sha256", "jpeg_sha256", "jpeg_len"}
    json.loads((REPO / "tests" / "torch_port_goldens.json").read_text())


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_goldens_small_fixtures(name):
    assert golden_entry(name) == load_goldens()[name]
    f = FIXTURES[name]
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(f["preset"]),
                           quality=f["quality"])
    jpeg = dt.encode_array(fixture_pixels(name), f["maxval"], cfg, device="cpu")
    assert len(jpeg) == load_goldens()[name]["jpeg_len"]


@pytest.mark.slow
def test_goldens_4k_fixture():
    assert golden_entry("4k_p420") == load_goldens()["4k_p420"]


def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the GPU")
    from dmmt_jpeg_encoder_tpu_torch.ops.fused_arai import fused_arai_phase1
    from dmmt_jpeg_encoder_tpu_torch.pipeline import phase1_zigzag_blocks

    f = FIXTURES["333x1001_p422"]
    rgb = torch.from_numpy(fixture_pixels("333x1001_p422")).cuda()
    q = torch.full((64,), 7, dtype=torch.uint8, device="cuda")
    preset = dt.ChromaSubsamplingPreset(f["preset"])
    for a, b in zip(fused_arai_phase1(rgb, 255, q, q, preset),
                    phase1_zigzag_blocks(rgb, 255, q, q, preset)):
        assert torch.equal(a, b)
    cfg = dt.EncoderConfig(chroma_subsampling=preset, quality=f["quality"])
    assert dt.encode_array(fixture_pixels("333x1001_p422"), 255, cfg, device="cuda") == \
        dt.encode_array(fixture_pixels("333x1001_p422"), 255, cfg, device="cpu")
