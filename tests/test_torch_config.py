"""The port's control-file schema against the JAX package's: the same YAML
through both ``load_config``s gives equal ``model_dump()``s, exactly (both
are the same pydantic models over the same keys; the port's copy differs
only in ``resolved_diffusive``, which takes the backend as an argument)."""

import pytest
import yaml

from troute_torch.config import load_config as torch_load
from troute_torch.config.schema import HybridParameters
from troute_tpu.config import load_config as jax_load

V4 = """
log_parameters:
    showtiming: True
    log_level: INFO
network_topology_parameters:
    supernetwork_parameters:
        geo_file_path: domain/RouteLink.nc
        mask_file_path: domain/mask.txt
        columns:
            key: link
            downstream: to
    waterbody_parameters:
        break_network_at_waterbodies: True
        level_pool:
            level_pool_waterbody_parameter_file_path: domain/LAKEPARM.nc
compute_parameters:
    parallel_compute_method: by-subnetwork-jit-clustered
    compute_kernel: V02-structured
    assume_short_ts: True
    strict_block_skip: true
    restart_parameters:
        start_datetime: 2021-08-23_13:00
        lite_channel_restart_file: restart/channel_restart_202108231300
    forcing_parameters:
        qts_subdivisions: 12
        dt: 300
        qlat_input_folder: channel_forcing
        qlat_file_pattern_filter: "*.CHRTOUT_DOMAIN1"
        nts: 36
        max_loop_size: 1
    data_assimilation_parameters:
        usgs_timeslices_folder: usgs_TimeSlice
        streamflow_da:
            streamflow_nudging: True
            lastobs_output_folder: lastobs
        reservoir_da:
            reservoir_persistence_da:
                reservoir_persistence_usgs: True
            reservoir_parameter_file: domain/reservoir_index_AnA.nc
output_parameters:
    csv_output:
        csv_output_folder: out
        csv_output_segments: [4, 5]
    chanobs_output:
        chanobs_output_directory: out
    lite_restart:
        lite_restart_output_directory: restart
    lakeout_output: lakeout
"""

# v3-era names: geo_file_type, wrf_hydro_lastobs_file, the flat
# reservoir_da keys and the waterbody_parameters.rfc block
V3 = """
network_topology_parameters:
    supernetwork_parameters:
        geo_file_type: NHDNetwork
        geo_file_path: domain/RouteLink.nc
    waterbody_parameters:
        break_network_at_waterbodies: True
        level_pool:
            level_pool_waterbody_parameter_file_path: domain/LAKEPARM.nc
        rfc:
            reservoir_parameter_file: domain/reservoir_index.nc
            reservoir_rfc_forecasts: True
            reservoir_rfc_forecasts_time_series_path: rfc_TimeSeries/
            reservoir_rfc_forecasts_lookback_hours: 48
compute_parameters:
    assume_short_ts: True
    forcing_parameters:
        dt: 300
        qts_subdivisions: 12
        nts: 24
        qlat_input_folder: channel_forcing
    data_assimilation_parameters:
        lastobs_output_folder: lastobs
        streamflow_da:
            streamflow_nudging: True
            wrf_hydro_lastobs_file: lastobs/nudgingLastObs.nc
        reservoir_da:
            gage_lakeID_crosswalk_file: domain/reservoir_index.nc
            reservoir_persistence_usgs: True
            reservoir_persistence_usace: True
            crosswalk_usgs_gage_field: my_gage_col
"""


@pytest.mark.parametrize("text, v3", [(V4, None), (V4, False), (V3, True),
                                      (V3, None), (V3, False)],
                         ids=["v4", "v4-gated", "v3", "v3-permissive",
                              "v3-ignored"])
def test_load_config_equal(tmp_path, text, v3):
    p = tmp_path / "cfg.yaml"
    p.write_text(text)
    got, want = torch_load(p, v3=v3), jax_load(p, v3=v3)
    assert got.model_dump() == want.model_dump()
    # the dump round-trips through YAML to the same configuration
    p2 = tmp_path / "again.yaml"
    yaml.safe_dump(got.model_dump(), open(p2, "w"))
    assert torch_load(p2, v3=False).model_dump() == got.model_dump()


def test_cross_field_rules_equal(tmp_path):
    """Both schemas refuse the same inconsistent file."""
    p = tmp_path / "bad.yaml"
    p.write_text("compute_parameters:\n    hybrid_parameters:\n"
                 "        run_hybrid_routing: True\n")
    for load in (torch_load, jax_load):
        with pytest.raises(ValueError, match="diffusive_domain"):
            load(p)


def test_resolved_diffusive_takes_the_backend():
    """The JAX schema asks JAX for its backend; the port's is told.  On
    the CPU both resolve "auto" to the exact float64 configuration, and
    pinned values pass through."""
    from troute_tpu.config.schema import HybridParameters as JaxHybrid
    hp = HybridParameters()
    assert hp.resolved_diffusive("cpu") == JaxHybrid().resolved_diffusive()
    assert hp.resolved_diffusive("cpu") == ("float64", None)
    assert hp.resolved_diffusive("cuda") == ("float32", 128)
    pinned = HybridParameters(diffusive_dtype="float64",
                              diffusive_table_nel=64)
    assert pinned.resolved_diffusive("cuda") == ("float64", 64)
