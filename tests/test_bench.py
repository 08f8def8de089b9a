"""Benchmark harness: cfg parsing, grammar output, end-to-end sequence run."""

import io
import os
import re

import jax
import numpy as np

from vk_gaussian_splatting_tpu.bench.sequencer import (
    BenchmarkSequencer,
    parse_sequence_file,
)
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats
from vk_gaussian_splatting_tpu.utils.memstats import MemoryStatistics
from vk_gaussian_splatting_tpu.utils.profiling import FrameTimers


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def test_parse_reference_cfg():
    """The parser handles sequence files in the reference's cfg grammar:
    quoted SEQUENCE blocks, valued and bare flags, several flags on a line,
    trailing comments."""
    blocks = parse_sequence_file(os.path.join(FIXTURES,
                                              "benchmark_3dgs.cfg"))
    assert blocks[0][0] == "Load scene and common settings"
    assert blocks[0][1]["sequenceframes"] == "1024"
    names = [b[0] for b in blocks]
    assert "Mesh pipeline fp16" in names
    mesh16 = dict(blocks)[("Mesh pipeline fp16")]
    assert mesh16["pipeline"] == "1" and mesh16["shformat"] == "1"
    assert "updateData" in mesh16

    rt = parse_sequence_file(os.path.join(FIXTURES, "benchmark_3dgrt.cfg"))
    kd = [b for _, b in rt if "kernelDegree" in b]
    assert kd and kd[0]["kernelDegree"] == "4"  # comment stripped


def test_timer_grammar_parsable_by_reference_regex():
    timers = FrameTimers()
    timers.add("GPU Dist", 0.00123)
    timers.add("Rasterization", 0.01)
    buf = io.StringIO()
    timers.print_timers(out=lambda s: buf.write(s + "\n"))
    text = buf.getvalue()
    pat = re.compile(
        r'Timer\s+"([^"]+)"\s*;\s*GPU;\s*avg\s+(\d+);.*?CPU;\s*avg\s+(\d+);')
    found = {m.group(1): int(m.group(2)) for m in pat.finditer(text)}
    assert found["GPU Dist"] == 1230
    assert found["Rasterization"] == 10000


def test_benchmark_adv_grammar():
    ms = MemoryStatistics()
    ms.set("Scene", host_used=100, device_used=200)
    buf = io.StringIO()
    ms.print_benchmark_adv(3, out=lambda s: buf.write(s + "\n"))
    text = buf.getvalue()
    assert re.search(r"BENCHMARK_ADV 3 {", text)
    m = re.search(
        r"Memory (\w+); Host used\s+(\d+); Device Used\s+(\d+); "
        r"Device Allocated\s+(\d+);", text)
    assert m and m.group(1) == "Scene" and int(m.group(2)) == 100


def test_sequencer_end_to_end(tmp_path):
    cfg_file = tmp_path / "mini.cfg"
    cfg_file.write_text(
        'SEQUENCE "setup"\n'
        "--sequenceframes 2\n--sequenceaverages 1\n--maxShDegree 1\n\n"
        'SEQUENCE "gs fp16"\n--pipeline 1\n--shformat 1\n--updateData \n\n'
        'SEQUENCE "gut"\n--pipeline 4\n--shformat 0\n--updateData \n'
        f'--screenshot "{tmp_path}/shot.png"\n'
    )
    splats = random_splats(jax.random.key(0), 200, sh_degree=1,
                           scale_range=(-2.5, -1.2))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], 64, 48)
    lines = []
    seq = BenchmarkSequencer(splats, 64, 48, cam, out=lambda s: lines.append(s),
                             max_pairs=32768)
    seq.run(parse_sequence_file(str(cfg_file)))
    text = "\n".join(lines)
    assert 'ParameterSequence 1 "gs fp16" =' in text
    assert re.search(r'Timer "Rasterization"; GPU; avg \d+;', text)
    assert re.search(r'Timer "GPU Sort"; GPU; avg \d+;', text)
    assert "BENCHMARK_ADV 2 {" in text
    import os
    assert (os.path.exists(tmp_path / "shot.png")
            or os.path.exists(str(tmp_path / "shot.png") + ".npy"))


def test_report_csv_and_parse(tmp_path):
    """The CSV/report stage parses the sequencer grammar (the loop the
    reference's benchmark.py closes, :19-78 + :486-615)."""
    from vk_gaussian_splatting_tpu.bench.report import (
        parse_benchmark_output,
        records_to_csv,
        write_report,
    )
    text = (
        'ParameterSequence 0 "warmup" =\n'
        'BENCHMARK_ADV 0 {\n'
        ' Memory Scene; Host used \t10; Device Used \t20; Device Allocated '
        '\t30; (bytes)\n}\n'
        'ParameterSequence 1 "gs fp32" =\n'
        'Timer "GPU Dist"; GPU; avg 120; min 120; max 120; CPU; avg 120; '
        'min 120; max 120;\n'
        'Timer "GPU Sort"; GPU; avg 4500; min 4500; max 4500; CPU; avg 4500; '
        'min 4500; max 4500;\n'
        'Timer "Rasterization"; GPU; avg 9000; min 9000; max 9000; CPU; '
        'avg 9000; min 9000; max 9000;\n'
        'BENCHMARK_ADV 1 {\n'
        ' Memory Rasterization; Host used \t0; Device Used \t512; Device '
        'Allocated \t1024; (bytes)\n}\n')
    recs = parse_benchmark_output(text)
    assert len(recs) == 2
    assert recs[1]["timers"]["GPU Sort"] == 4500.0
    assert recs[1]["memory"]["Rasterization"] == (0, 512, 1024)
    csv_text = records_to_csv(recs, scene="bicycle")
    assert "GPU Sort avg us" in csv_text.splitlines()[0]
    assert "bicycle,1,gs fp32" in csv_text
    out_csv = tmp_path / "r.csv"
    write_report(text, str(out_csv), scene="bicycle",
                 chart_path=str(tmp_path / "r.png"))
    assert out_csv.exists()


def test_sequencer_gut_sort_uses_gut_rows(monkeypatch):
    """Pipelines 2/4/5 must time the sort over the gut3d attribute rows, not
    the gs2d rows (the stage the reference's 3DGUT/3DGRT tables report)."""
    import vk_gaussian_splatting_tpu.render.pipelines as plm
    calls = []
    orig = plm.gut_attr_rows
    monkeypatch.setattr(plm, "gut_attr_rows",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    splats = random_splats(jax.random.key(1), 100, sh_degree=1,
                           scale_range=(-2.5, -1.2))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], 64, 48)
    seq = BenchmarkSequencer(splats, 64, 48, cam, out=lambda s: None,
                             max_pairs=16384)
    seq.apply({"pipeline": "4", "sequenceframes": "1",
               "sequenceaverages": "1"})
    seq.update_data()
    seq._measure()
    assert calls, "gut sort stage must build gut attribute rows"
