"""Version and build info (the JAX package's ``version.py``, for the
port): ``mpi.Get_library_version`` reports :func:`version_string`."""

VERSION = "0.1.0"
MPI_STANDARD = "3.1-subset"
FRAMEWORK_NAME = "mvapich2-tpu"


def version_string() -> str:
    return (f"{FRAMEWORK_NAME} {VERSION} (MPI {MPI_STANDARD}, "
            f"PyTorch/CUDA port)")
