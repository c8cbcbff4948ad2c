"""Self-adaptive GEMM — the paper's contribution end to end, on the port.

  PYTHONPATH=src python examples/torch/selfadaptive_gemm.py        # the card
  PYTHONPATH=src python examples/torch/selfadaptive_gemm.py --device cpu \\
      --samples 6000 --epochs 2 --layers 4

The port's counterpart of ``examples/selfadaptive_gemm.py``, a thin front
to ``repro_torch.launch.selfadaptive_gemm``: ADAPTNET-TPU is trained on
the tile-config space (60 000 samples, 8 epochs), each of the first 10
synthetic Table-IV GEMMs asks the ADAPTNETX kernel for its tile and runs
through the RSA GEMM kernel with it.  Runs on CUDA unless ``--device
cpu`` is given; without CUDA it raises.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.selfadaptive_gemm import main  # noqa: E402,F401

if __name__ == "__main__":
    main()
