"""PyTorch port end to end: JPEG bytes, CLI, carried-over state, the
jax-free import, the kernel build line and the cross-framework goldens.

On the CPU the JAX package's encode_array runs its two-dispatch host path,
whose bytes the JAX suite pins equal to every device path; the port's
encode_array(device="cpu") runs the one-dispatch path with the kernels'
plain versions (its two-dispatch paths: test_torch_two_dispatch.py).
Bytes must be identical."""

import json
import os
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
from torch_port_fixtures import (
    FIXTURES,
    ROUTE_BATCHES,
    ROUTES,
    SMALL_FIXTURES,
    fixture_pixels,
    golden_entry,
    load_goldens,
    load_route_goldens,
)

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


@pytest.fixture
def torch_pool_of_every_core():
    """torch's intra-op pool on every core, as outside the parallel test
    run, whose workers each get a share (torch_port_fixtures.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(len(os.sched_getaffinity(0)))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset,shape,maxval,quality,qtable", [BYTE_CASES[3], BYTE_CASES[8]])
def test_encode_array_bytes_match_jax_on_every_core(torch_pool_of_every_core, preset, shape,
                                                    maxval, quality, qtable):
    assert torch.get_num_threads() == len(os.sched_getaffinity(0))
    test_encode_array_bytes_match_jax(preset, shape, maxval, quality, qtable)


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


@pytest.mark.parametrize("flags", [["--dct", "fused"], ["--shards", "2"], ["--dct", "separated"],
                                   ["--dct", "simple"], ["--shards", "4"]])
def test_cli_refuses_unported_options(tmp_path, flags):
    """Nothing is refused any more: sharding and the DCT variants run, with
    the JAX CLI's bytes; --no-native, --scan-backend host and --one-dispatch
    off run (test_torch_two_dispatch.py)."""
    src = tmp_path / "in.ppm"
    write_ppm(src, _image(6, (8, 8)))
    out = tmp_path / "o.jpg"
    want = tmp_path / "jax.jpg"
    assert jax_cli.main([str(src), str(want), *flags]) == 0
    assert port_cli.main([str(src), str(out), *flags, "--device", "cpu"]) == 0
    assert out.read_bytes() == want.read_bytes()


def test_cli_flags_mirror_jax():
    def flags(parser):
        return sorted(s for a in parser._actions for s in a.option_strings)

    extra = set(flags(port_cli.build_parser())) - set(flags(jax_cli.build_parser()))
    assert extra == {"--device"}
    assert set(flags(jax_cli.build_parser())) <= set(flags(port_cli.build_parser()))


def test_unported_configs_raise():
    """No config raises (DMMT_P1_PREC=high encodes:
    test_torch_p1_precision_high.py): the SEPARATED variant and sharding
    (fused_batch ignored) encode with the JAX package's bytes; the host
    backend and one_dispatch="off" encode (test_torch_two_dispatch.py)."""
    px = _image(7, (8, 8))
    cfg = dt.EncoderConfig(dct_variant=dt.DCTVariant.SEPARATED)
    want = dj.encode_array(px, 255, dj.EncoderConfig(dct_variant=dj.DCTVariant.SEPARATED))
    assert dt.encode_array(px, 255, cfg, device="cpu") == want
    assert dt.encode_batch([px, px], 255, cfg, fused_batch=2, device="cpu") == [want, want]
    cfg = dt.EncoderConfig(num_shards=2)
    want = dj.encode_array(px, 255, dj.EncoderConfig(num_shards=2))
    assert dt.encode_array(px, 255, cfg, device="cpu") == want
    assert dt.encode_batch([px, px], 255, cfg, fused_batch=2, device="cpu") == [want, want]


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
        "off = p.EncoderConfig(one_dispatch='off')\n"
        "assert p.encode_array(px, 255, off, device='cpu') == jpeg\n"
        "host = p.EncoderConfig(scan_backend='host')\n"
        "assert p.encode_array(px, 255, host, use_native=False, device='cpu') == jpeg\n"
        "assert p.encode_batch([px, px[::-1].copy(), px], 255, fused_batch=2,"
        " device='cpu')[::2] == [jpeg, jpeg]\n"
        "fused = p.EncoderConfig(dct_variant=p.DCTVariant.FUSED)\n"
        "assert p.encode_batch([px, px], 255, fused, fused_batch=2, device='cpu')[0] == "
        "p.encode_array(px, 255, fused, device='cpu')\n"
        "sharded = p.EncoderConfig(num_shards=2)\n"
        "assert p.encode_array(px, 255, sharded, device='cpu') == jpeg\n"
        "assert p.encode_batch([px, px], 255, sharded, device=['cpu', 'cpu']) == [jpeg, jpeg]\n"
        "from dmmt_jpeg_encoder_tpu_torch.parallel import multihost\n"
        "assert multihost.encode_array_distributed(px, 16, 24, 255, sharded, device='cpu') == jpeg\n"
        "from dmmt_jpeg_encoder_tpu_torch.utils import capability\n"
        "assert not capability.kernels_capable('cpu')\n"
        "import os; os.environ['DMMT_P1'] = 'mxu'\n"
        "assert p.encode_batch([px, px], 255, device='cpu')[0] == p.encode_array(px, 255, device='cpu')\n"
        "from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import check_p1_precision, dot_p1, split_bf16\n"
        "os.environ['DMMT_P1_PREC'] = 'high'; assert check_p1_precision() == 'high'\n"
        "assert p.encode_batch([px, px], 255, device='cpu')[0] == p.encode_array(px, 255, device='cpu')\n"
        "os.environ['DMMT_P1'] = 'fused1'\n"
        "assert p.encode_batch([px, px], 255, device='cpu')[0] == p.encode_array(px, 255, device='cpu')\n"
        "import torch; c = torch.eye(8); assert torch.equal(dot_p1(c, c), c)\n"
        "assert torch.equal(sum(split_bf16(torch.tensor([1.0, 0.5]))), torch.tensor([1.0, 0.5]))\n"
        "os.environ['DMMT_P1'] = 'mxu'; del os.environ['DMMT_P1_PREC']\n"
        "from dmmt_jpeg_encoder_tpu_torch.utils.native import load_native\n"
        "assert load_native() is not None\n"
        "del os.environ['DMMT_P1']\n"
        "from dmmt_jpeg_encoder_tpu_torch import onedispatch as od\n"
        "from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair\n"
        "cfg = p.EncoderConfig(); lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)\n"
        "scan = od.finish_one_dispatch(od.start_one_dispatch(px, 255, cfg, lq, cq, device='cpu'))\n"
        "planar = np.ascontiguousarray(px.transpose(2, 0, 1))\n"
        "assert od.finish_one_dispatch(od.start_one_dispatch(planar, 255, cfg, lq, cq, device='cpu'),"
        " cfg) == scan\n"
        "group = od.start_one_dispatch_multi(np.stack([planar, planar]), 255, cfg, lq, cq, device='cpu')\n"
        "assert [od.finish_one_dispatch(s, cfg) for s in group] == [scan, scan]\n"
        "from dmmt_jpeg_encoder_tpu_torch.bitstream.scan_stuff import stuff_scan\n"
        "w = torch.zeros(32, dtype=torch.int32); w[0] = -1\n"
        "assert stuff_scan(w, torch.tensor([32])).tolist() == [8]\n"
        "from dmmt_jpeg_encoder_tpu_torch.debug.jpeg_decoder import decode_jpeg, parse_jpeg\n"
        "assert decode_jpeg(jpeg).shape == (16, 24, 3) and parse_jpeg(jpeg).width == 24\n"
        "from dmmt_jpeg_encoder_tpu_torch.huffman import HuffmanDecoder\n"
        "from dmmt_jpeg_encoder_tpu_torch.huffman.tree import HuffmanTree\n"
        "assert '(s:2,f:3)' in str(HuffmanTree([(1, 5), (2, 3), (3, 9)]))\n"
        "from dmmt_jpeg_encoder_tpu_torch.utils.profiling import stage_timer, trace\n"
        "with stage_timer() as t:\n"
        "    t.lap('x')\n"
        "assert 'total:' in t.report()\n"
        "from dmmt_jpeg_encoder_tpu_torch.ops.dct import idct2d\n"
        "from dmmt_jpeg_encoder_tpu_torch.ops.geometry import subsample_generalized\n"
        "from dmmt_jpeg_encoder_tpu_torch import bench\n"
        "assert bench.frame_pixels(16, 24).shape == (16, 24, 3)\n"
        "assert bench.main(['--child', '--device', 'cpu', '--width', '24', '--height', '16',"
        " '--rounds', '1', '--device-only', '--no-8k', '--no-slab']) == 0\n"
        "from dmmt_jpeg_encoder_tpu_torch.parallel import projection\n"
        "assert [r['chips'] for r in projection.projected_scaling_table(slab_b=None)] == [1, 2, 4, 8]\n"
        "assert capability.trace_mode_key()[0] == 'plane'\n"
        "from dmmt_jpeg_encoder_tpu_torch import programs\n"
        "pool = od._compiled_onedispatch(16, 24, cfg.chroma_subsampling, cfg.dct_variant, False,"
        " *programs.program_key(px, 255, lq, cq, torch.device('cuda', 0)))\n"
        "assert pool.idle == [] and programs.graph_bytes() == 0\n"
        "assert programs.card(px, 'cpu') is None and programs.card(px, ['cpu', 'cpu:0']) is None\n"
        "from dmmt_jpeg_encoder_tpu_torch.huffman.tables import HuffmanTables, split_histograms\n"
        "assert HuffmanTables is p.HuffmanTables and len(split_histograms(np.zeros(544))) == 4\n"
        "bad = [m for m in sys.modules if m == 'jaxlib' or m.startswith(('jax.', 'dmmt_jpeg_encoder_tpu.'))"
        " or m == 'dmmt_jpeg_encoder_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_nvcc_command_line():
    assert [s.name for s in build.sources()] == [
        "block_dct.cu", "block_hist.cu", "emission_pack.cu", "fused_phase1.cu", "histogram.cu",
        "mxu_dct.cu", "phase1.cu", "plane_dct.cu", "probe.cu", "scan_pack.cu", "scan_stuff.cu",
        "table_lookup.cu"]
    assert [h.name for h in build.headers()] == ["dct8.cuh", "strip.cuh"]
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
    for source in native.SOURCES:
        assert source.is_file() and port in source.parents
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
    routes, route_batches = load_route_goldens()
    assert set(routes) == set(ROUTES) and all(set(r) == set(FIXTURES) for r in routes.values())
    assert {r: sorted(b) for r, b in route_batches.items()} == ROUTE_BATCHES
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
    from dmmt_jpeg_encoder_tpu_torch.ops.fused_phase1 import fused_phase1, fused_phase1_reference

    for a, b in zip(fused_phase1(rgb, 255, q, q, preset), fused_phase1_reference(rgb, 255, q, q, preset)):
        assert torch.equal(a, b)
    px = fixture_pixels("333x1001_p422")
    for variant in dt.DCTVariant:
        cfg = dt.EncoderConfig(chroma_subsampling=preset, quality=f["quality"], dct_variant=variant)
        assert dt.encode_array(px, 255, cfg, device="cuda") == dt.encode_array(px, 255, cfg, device="cpu")
