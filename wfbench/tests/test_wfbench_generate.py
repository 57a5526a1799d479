"""The frozen generators give what the port's own give on the same seed, and
a traffic file's traffic depends on the seed alone."""
import numpy as np
import pytest

from wfbench import generate
from wfbench.spec import Geometry, config_fields


@pytest.fixture(scope="module")
def both():
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    fields = config_fields("nps_rg1a_fp32")
    cfg = NPSConfig.from_json(__import__("json").dumps(fields))
    g = Geometry(fields)
    seed = [2 ** 31 + 7, 0, 0]
    return (cfg, g, synthetic_calibration(cfg, run=3000, seed=seed),
            generate.synthetic_calibration(g, run=3000, seed=seed))


def test_calibration_equals_the_ports(both):
    _, _, port, ours = both
    for k, v in ours.items():
        assert np.array_equal(np.asarray(getattr(port, k)), np.asarray(v)), k


@pytest.mark.parametrize("occupancy,max_pulses,pileup", [
    (0.03, 2, 0.3), (1.0, 2, 0.25), (1.0, 4, 0.9)])
def test_events_equal_the_ports(both, occupancy, max_pulses, pileup):
    from npswf_tpu_torch.utils.synthetic import make_events
    cfg, g, port_cal, ours_cal = both
    seed = [2 ** 31 + 9, 1, 3]
    a = make_events(cfg, port_cal, 2, occupancy=occupancy,
                    max_pulses=max_pulses, pileup_prob=pileup, seed=seed)
    b = generate.make_events(g, ours_cal, 2, occupancy=occupancy,
                             max_pulses=max_pulses, pileup_prob=pileup,
                             seed=seed)
    for k, v in b.items():
        assert np.array_equal(getattr(a, k), v), k


def test_segment_equals_the_ports(both):
    from npswf_tpu_torch.io.rawstream import build_segment
    from npswf_tpu_torch.tools.cli import synth_records
    from npswf_tpu_torch.utils.synthetic import make_events
    cfg, g, port_cal, ours_cal = both
    truth = make_events(cfg, port_cal, 3, occupancy=0.03, seed=11)
    ours = generate.make_events(g, ours_cal, 3, occupancy=0.03, seed=11)
    pres = truth.npulse > 0
    s_a, h_a = synth_records(cfg, truth, np.random.default_rng(5), pres=pres)
    s_b, h_b = generate.synth_records(g, ours, np.random.default_rng(5),
                                      pres=pres)
    evt, run = np.arange(1, 4, dtype=np.float64), np.full(3, 3000.0)
    seg = build_segment(cfg, s_a, h_a, evt, run)
    mine = generate.build_segment(s_b, h_b, evt, run)
    for k, v in mine.items():
        assert np.array_equal(getattr(seg, k), v), k


@pytest.mark.parametrize("mix", ["batch_dense", "segment_sparse"])
def test_traffic_is_made_from_the_seed_alone(mix):
    from wfbench import spec
    fields = config_fields("nps_rg1a_fp32")
    t = dict(spec.traffic(mix), events_per_call=1, pool=2, events=3)
    one = generate.make_traffic(fields, t, 2 ** 33 + 1, workers=1)
    two = generate.make_traffic(fields, t, 2 ** 33 + 1, workers=2)
    other = generate.make_traffic(fields, t, 2 ** 33 + 2, workers=1)
    if mix == "batch_dense":
        for x, y in zip(one["batches"], two["batches"]):
            assert all(np.array_equal(a, b) for a, b in zip(x, y))
        assert not np.array_equal(one["batches"][0][0],
                                  other["batches"][0][0])
        assert one["batches"][0][0].shape == (1, 1080, 110)
    else:
        for k in one["segment"]:
            assert np.array_equal(one["segment"][k], two["segment"][k]), k
        assert not np.array_equal(one["segment"]["stream"],
                                  other["segment"]["stream"])
        assert one["segment"]["evt"].tolist() == [1.0, 2.0, 3.0]
