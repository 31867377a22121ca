"""The port's examples (relativisticraytracer_tpu_torch/examples/) are
documentation that executes, as the JAX package's are
(tests/test_examples.py): so parse them, resolve their imports, and run
each one as a subprocess at its RRT_EXAMPLE_SMOKE size on the CPU
(RRT_DEVICE=cpu). They import only the port, and with RRT_DEVICE unset
they run on CUDA or fail: no hidden switch to the CPU."""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu_torch import Renderer, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import decode_png, load_skybox
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES_DIR = ROOT / "relativisticraytracer_tpu_torch" / "examples"
NAMES = ["render_still.py", "render_animation.py", "custom_scene.py", "multi_chip.py",
         "frame_parallel_animation.py", "live_preview.py"]
# what each smoke run leaves in its working directory
OUTPUTS = {
    "render_still.py": ["still.png"],
    "render_animation.py": ["flyby.rgba", "flyby.json"],
    "custom_scene.py": ["custom_t0.png", "custom_t5.png", "custom_t10.png"],
    "multi_chip.py": ["sharded.png"],
    "frame_parallel_animation.py": ["flyby_720p.rgba", "flyby_720p.json"],
    "live_preview.py": [],
}


def test_the_six_examples_are_there():
    assert sorted(p.name for p in EXAMPLES_DIR.glob("*.py")) == sorted(NAMES)
    assert not (EXAMPLES_DIR / "__init__.py").exists()  # scripts, never walked as modules
    readme = (EXAMPLES_DIR / "README.md").read_text()
    assert all(f"`{name}`" in readme for name in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_parses_and_imports_only_the_port(name):
    path = EXAMPLES_DIR / name
    text = path.read_text()
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules = [node.module or ""]
        else:
            continue
        for module in modules:
            top = module.split(".")[0]
            assert top not in ("jax", "jaxlib", "relativisticraytracer_tpu"), \
                f"{name} imports {module}"
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "relativisticraytracer_tpu_torch"):
            mod = importlib.import_module(node.module)
            for alias in node.names:
                assert hasattr(mod, alias.name), f"{name}: {node.module}.{alias.name} missing"
    assert "RRT_EXAMPLE_SMOKE" in text, f"{name}: missing the RRT_EXAMPLE_SMOKE escape hatch"
    assert 'os.environ.get("RRT_DEVICE", "cuda")' in text, f"{name}: no RRT_DEVICE (cuda)"


def _run(name, cwd, **env_over):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
        RRT_EXAMPLE_SMOKE="1", RRT_RECORDING_DIR=str(cwd), OMP_NUM_THREADS="2")
    env.pop("RRT_DEVICE", None)
    env.update(env_over)
    return subprocess.run([sys.executable, str(EXAMPLES_DIR / name)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", NAMES)
def test_example_executes_on_cpu(name, tmp_path):
    proc = _run(name, tmp_path, RRT_DEVICE="cpu")
    assert proc.returncode == 0, (f"{name} failed\n--- stdout ---\n{proc.stdout}"
                                  f"\n--- stderr ---\n{proc.stderr}")
    for out in OUTPUTS[name]:
        assert (tmp_path / out).stat().st_size > 0, f"{name}: no {out}"
    if name == "render_still.py":
        # bitwise the Renderer at the smoke settings
        want = Renderer(SceneConfig(), RenderSettings(width=64, height=48, max_steps=16),
                        skybox_rgba=load_skybox(None, fallback_shape=(32, 64), device="cpu"),
                        device="cpu").render_np(
            camera_state_from_pose(pos=(0.0, 10.0, -60.0), yaw=0.0, pitch=-10.0), time=1.0)
        np.testing.assert_array_equal(decode_png(tmp_path / "still.png"), want)
    if name == "multi_chip.py":
        assert "4x2 grid over 1 distinct device(s)" in proc.stdout


def test_example_without_rrt_device_does_not_fall_back_to_the_cpu(tmp_path):
    """RRT_DEVICE unset means cuda: without a card the script fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would render on it")
    proc = _run("render_still.py", tmp_path)
    assert proc.returncode != 0
    assert not (tmp_path / "still.png").exists()
