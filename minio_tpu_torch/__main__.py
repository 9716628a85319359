"""`python -m minio_tpu_torch` entry point (reference main.go:34 -> cmd.Main)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
