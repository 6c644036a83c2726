"""MPI-IO over the host windows (a copy of the JAX package's ``io``).

Layers: ``adio.py`` (the file-access drivers ufs and memfs),
``view.py`` (file views flattened into physical runs), ``file.py``
(``MPI_File``: independent, collective, shared-pointer, ordered and
nonblocking IO, data sieving, two-phase collective buffering).
"""

from .adio import (MODE_APPEND, MODE_CREATE, MODE_DELETE_ON_CLOSE,
                   MODE_EXCL, MODE_RDONLY, MODE_RDWR, MODE_SEQUENTIAL,
                   MODE_UNIQUE_OPEN, MODE_WRONLY, delete_file)
from .file import (SEEK_CUR, SEEK_END, SEEK_SET, File, file_delete,
                   file_open)

__all__ = [
    "File", "file_open", "file_delete", "delete_file",
    "MODE_RDONLY", "MODE_RDWR", "MODE_WRONLY", "MODE_CREATE", "MODE_EXCL",
    "MODE_DELETE_ON_CLOSE", "MODE_UNIQUE_OPEN", "MODE_SEQUENTIAL",
    "MODE_APPEND", "SEEK_SET", "SEEK_CUR", "SEEK_END",
]
