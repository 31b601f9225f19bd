# nxsearch-tpu service image.
#
# The reference ships an OpenResty image built by docker-compose
# (compose/svc.Dockerfile); the equivalent here is a Python image
# running the stdlib HTTP service.  Tests run during the build, like
# the reference's multi-stage image.
#
# The service serves from the host's NVIDIA GPU (docker run --gpus
# all): JAX comes with its CUDA 12 plugin.  The test stage pins the
# CPU (tests/conftest.py), so the image builds on a host without one.

FROM python:3.12-slim AS base

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/nxsearch-tpu
COPY native/ native/
COPY nxsearch_tpu/ nxsearch_tpu/
COPY tests/ tests/
COPY README.md .

RUN pip install --no-cache-dir "jax[cuda12]" numpy pytest \
    && make -C native

# lib/test target: run the suite during the build (reference
# svc.Dockerfile runs `make tests` + luajit tests/test.lua).
FROM base AS lib
RUN python -m pytest tests/ -q

# app target: the REST service.
FROM base AS app
ENV NXS_BASEDIR=/data
VOLUME /data
EXPOSE 8000
CMD ["python", "-m", "nxsearch_tpu.service", "--port", "8000"]
