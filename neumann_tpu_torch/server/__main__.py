"""`python -m neumann_tpu_torch.server` — the gRPC server, on the card
unless ``--device cpu`` is given."""

from neumann_tpu_torch.server.server import main

if __name__ == "__main__":
    raise SystemExit(main())
