# EBCC-TPU container (reference analogue: /root/reference/docker/ — the
# reference ships a Dockerfile + enroot/podman configs for its cluster).
#
# Build:  docker build -t ebcc-tpu .
# Run:    docker run --rm ebcc-tpu python -m pytest tests/ -q
# On GPU hosts install the CUDA wheel, "jax[cuda12]", instead of jax[cpu].

FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make libzstd-dev && \
    rm -rf /var/lib/apt/lists/*

WORKDIR /opt/ebcc_tpu
COPY pyproject.toml ./
RUN pip install --no-cache-dir \
        "jax[cpu]" flax optax numpy h5py zstandard pytest

COPY . .
RUN make -C native

ENV HDF5_PLUGIN_PATH=/opt/ebcc_tpu/native
CMD ["python", "-m", "pytest", "tests/", "-q"]
