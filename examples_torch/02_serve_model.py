"""Serve the latest model checkpoint over HTTP (reference
``notebooks/2-serve-model.ipynb`` / ``stage_2_serve_model.py``), on the
PyTorch/CUDA port (``examples/02_serve_model.py`` is the JAX version).

Parameters are loaded from the newest date-keyed checkpoint straight onto
the card; ``/score/v1`` keeps the reference's exact JSON contract:

    request:  {"X": 50}
    response: {"prediction": <float>, "model_info": "<model description>"}

plus a batched endpoint ``/score/v1/batch`` ({"X": [..]} -> {"predictions":
[..]}) that pads each request into a captured row bucket, so no request
shape ever builds a new program. ``auto`` serves a wide MLP through the
fused CUDA kernel.

    python examples_torch/02_serve_model.py &
    curl -X POST localhost:5000/score/v1 \
         -H 'Content-Type: application/json' -d '{"X": 50}'
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run


from bodywork_tpu_torch.serve import serve_latest_model
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-example-store"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--store", default=DEFAULT_STORE)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument(
        "--mesh-data",
        type=int,
        default=None,
        help="shard request batches over this many devices",
    )
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args()

    configure_logger()
    serve_latest_model(
        open_store(args.store),
        host=args.host,
        port=args.port,
        mesh_data=args.mesh_data,
        device=args.device,
    )


if __name__ == "__main__":
    main()
