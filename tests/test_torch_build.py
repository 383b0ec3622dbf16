"""The kernel build (``_build.build``) under concurrent builds: two processes
that build at once on a fresh tree must each link only complete objects of
their own build, and both must end with a whole library. The CUDA compiler
is replaced by a fake ``nvcc`` that writes its object slowly, in two parts,
so that builds which shared object files would link one another's halves."""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Compile: `-c SRC -o OBJ` writes "BEGIN <build tag>", waits, then the rest.
# Link: `-shared -o OUT OBJ...` fails unless every object is complete and
# carries this build's tag, then writes the tags it linked.
FAKE_NVCC = textwrap.dedent("""\
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    tag = os.environ["BUILD_TAG"]
    if "-c" in args:
        src = args[args.index("-c") + 1]
        with open(out, "w") as f:
            f.write(f"BEGIN {tag}\\n")
            f.flush()
            time.sleep(0.4)
            f.write(f"{os.path.basename(src)} END\\n")
        sys.exit(0)
    objs = [a for a in args[args.index("-o") + 2:]]
    for obj in objs:
        with open(obj) as f:
            text = f.read()
        if text != f"BEGIN {tag}\\n{os.path.basename(obj)[:-2]}.cu END\\n":
            print(f"build {tag} links a foreign or partial object {obj}: {text!r}")
            sys.exit(1)
    time.sleep(0.2)
    with open(out, "w") as f:
        f.write(" ".join(sorted(os.path.basename(o) for o in objs)) + f" {tag}\\n")
""")

BUILD_CHILD = textwrap.dedent("""\
    import json, os, sys
    from nav2_social_mpc_controller_tpu_torch import _build
    csrc, build_dir, nvcc = sys.argv[1:4]
    _build.CSRC_DIR = csrc
    _build.BUILD_DIR = build_dir
    _build.find_nvcc = lambda: nvcc
    path = _build.build()
    with open(path) as f:
        print(json.dumps({"lib": path, "content": f.read()}))
""")


def _fake_tree(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    return str(csrc), str(tmp_path / "build"), str(nvcc)


def test_two_concurrent_builds_each_link_their_own_objects(tmp_path):
    csrc, build_dir, nvcc = _fake_tree(tmp_path)
    env_base = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD_CHILD, csrc, build_dir, nvcc],
                         env=dict(env_base, BUILD_TAG=tag), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in ("first", "second")
    ]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    lib = os.path.join(build_dir, "libsocial_mpc_kernels.so")
    for res in results:
        assert res["lib"] == lib
        # Each build opened a whole library: all three objects of one build.
        objs, tag = res["content"].split()[:3], res["content"].split()[3]
        assert objs == ["a.o", "b.o", "c.o"] and tag in ("first", "second")
    with open(lib) as f:
        assert f.read().split()[:3] == ["a.o", "b.o", "c.o"]
    # Nothing of either build is left beside the library.
    assert sorted(os.listdir(build_dir)) == ["libsocial_mpc_kernels.so"]


def test_a_fresh_library_is_not_rebuilt(tmp_path):
    csrc, build_dir, nvcc = _fake_tree(tmp_path)
    env = dict(os.environ, BUILD_TAG="only",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = [sys.executable, "-c", BUILD_CHILD, csrc, build_dir, nvcc]
    first = subprocess.run(run, env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert first.returncode == 0, first.stderr[-3000:]
    lib = os.path.join(build_dir, "libsocial_mpc_kernels.so")
    built = os.path.getmtime(lib)
    second = subprocess.run(run, env=dict(env, BUILD_TAG="other"), cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert second.returncode == 0, second.stderr[-3000:]
    assert os.path.getmtime(lib) == built
    assert json.loads(second.stdout.strip().splitlines()[-1])["content"].endswith("only\n")
