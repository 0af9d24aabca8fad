"""CLI flags, text-UI guards, and YAML config loaders."""

import os

import pytest
import yaml

from hipsc_abm.utils import cli
from hipsc_abm.utils.config import check_direct, check_output_dir, template_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_commandline_param():
    argv = ["prog", "-n", "mysim", "-m", "2", "-fs", "300"]
    assert cli.commandline_param("-n", str, argv) == "mysim"
    assert cli.commandline_param("-m", int, argv) == 2
    assert cli.commandline_param("-fs", int, argv) == 300
    with pytest.raises(Exception):
        cli.commandline_param("-x", str, argv)
    with pytest.raises(Exception):
        cli.commandline_param("-fs", int, ["prog", "-fs"])  # missing value


def test_get_name_mode_and_final_step():
    assert cli.get_name_mode(["p", "-n", "a", "-m", "0"]) == ("a", 0)
    assert cli.get_final_step(["p", "-fs", "7"]) == 7


def test_check_new_sim_creates_and_guards(tmp_path):
    out = str(tmp_path) + os.sep
    name = cli.check_new_sim("fresh", out)
    assert name == "fresh" and os.path.isdir(tmp_path / "fresh")
    # existing dir, non-interactive, no overwrite permission -> raises
    with pytest.raises(Exception):
        cli.check_new_sim("fresh", out)
    # explicit overwrite clears contents
    (tmp_path / "fresh" / "junk.txt").write_text("x")
    cli.check_new_sim("fresh", out, overwrite=True)
    assert os.listdir(tmp_path / "fresh") == []


def test_check_previous_sim(tmp_path):
    out = str(tmp_path) + os.sep
    os.mkdir(tmp_path / "old")
    assert cli.check_previous_sim("old", out) == "old"
    with pytest.raises(Exception):
        cli.check_previous_sim("nope", out)


def test_template_params_and_output_dir(tmp_path, monkeypatch):
    p = tmp_path / "t.yaml"
    p.write_text(yaml.dump({"a": 1, "size": [10, 20, 0]}))
    keys = template_params(str(p))
    assert keys["a"] == 1 and keys["size"] == [10, 20, 0]

    monkeypatch.chdir(tmp_path)
    (tmp_path / "paths.yaml").write_text(yaml.dump({"output_dir": str(tmp_path / "outs")}))
    out = check_output_dir(interactive=False)
    assert os.path.isdir(tmp_path / "outs") and out.endswith(os.path.sep)

    check_direct(str(tmp_path / "deep"))
    assert os.path.isdir(tmp_path / "deep")


def test_params_dataclass_roundtrip():
    from hipsc_abm.models.params import ExperimentalParams, GeneralParams

    g = GeneralParams.from_dict({
        "num_to_start": 10, "cuda": False, "end_step": 5, "size": [100, 100, 0],
        "output_values": True, "output_images": False, "record_initial_step": True,
        "image_quality": 50, "video_quality": 40, "fps": 2,
    })
    assert g.num_to_start == 10 and g.is_2d
    x = ExperimentalParams.from_dict({
        "num_gata6": 3, "output_tda": False, "output_gradients": False, "group": 0,
        "dox_step": 9, "guye_move": False, "lonely_thresh": 1, "color_mode": False,
    })
    assert x.dox_step == 9 and not x.guye_move


_EXAMPLE_YAML = sorted(
    os.path.relpath(os.path.join(d, f), _REPO)
    for d, _, files in os.walk(os.path.join(_REPO, "examples"))
    for f in files if f.endswith(".yaml")
)


@pytest.mark.parametrize("relpath", _EXAMPLE_YAML)
def test_builtin_yaml_reader_matches_pyyaml(relpath):
    """The built-in reader equals ``yaml.safe_load`` on every shipped
    template (the engine needs no PyYAML)."""
    from hipsc_abm.utils.config import load_flat_yaml

    with open(os.path.join(_REPO, relpath)) as f:
        text = f.read()
    assert load_flat_yaml(text) == yaml.safe_load(text)


def _cache_dir_in_fresh_process(env_value):
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax\n"
            "from hipsc_abm.utils.config import ensure_compilation_cache\n"
            "ensure_compilation_cache()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(want) == want


def test_compile_cache_defaults_to_checkout():
    from hipsc_abm.utils.config import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(_REPO, ".jax_cache")
    assert _cache_dir_in_fresh_process(None) == DEFAULT_CACHE_DIR
