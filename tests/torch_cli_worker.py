"""Worker of the port's two-process pipeline test (``tests/test_torch_cli.py``).

Launched as ``python torch_cli_worker.py <project> <setup.yml>`` with
``YAWT_COORDINATOR`` / ``YAWT_NUM_PROCESSES`` / ``YAWT_PROCESS_ID`` set per
process: the command line joins the gloo job (``parallel.initialize``) and
runs the setup on the CPU together with the other process. Prints ``CLI
OK`` when the run succeeded. Imports no JAX. Not collected by pytest (no
``test_`` prefix).
"""

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from yet_another_wizz_tpu_torch.cli.commandline import main  # noqa: E402

if __name__ == "__main__":
    project, setup = sys.argv[1:3]
    code = main([project, setup, "--quiet", "--device", "cpu"])
    if code != 0:
        sys.exit(code)
    print("CLI OK", flush=True)
