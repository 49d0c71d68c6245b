"""Google-drive file download with progress (mirrors
``refid_tpu/utils/download_util.py``; upstream
``basicsr/utils/download_util.py:8-70``).  ``requests`` and ``tqdm`` are
imported inside the functions that use them; nothing downloads unless
:func:`download_file_from_google_drive` is called."""

from __future__ import annotations

import math

__all__ = ["download_file_from_google_drive", "get_confirm_token",
           "save_response_content", "sizeof_fmt"]

_DRIVE_URL = "https://docs.google.com/uc?export=download"


def sizeof_fmt(size, suffix="B"):
    """1024-based human size, as upstream's ``misc.sizeof_fmt``."""
    for unit in ("", "K", "M", "G", "T", "P", "E", "Z"):
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"


def download_file_from_google_drive(file_id, save_path):
    """Stream a google-drive file to ``save_path``, echoing the large-file
    confirm token when drive serves one."""
    import requests
    session = requests.Session()
    params = {"id": file_id}
    response = session.get(_DRIVE_URL, params=params, stream=True)
    token = get_confirm_token(response)
    if token:
        params["confirm"] = token
        response = session.get(_DRIVE_URL, params=params, stream=True)
    size_probe = session.get(_DRIVE_URL, params=params, stream=True,
                             headers={"Range": "bytes=0-2"})
    file_size = None
    if "Content-Range" in size_probe.headers:
        file_size = int(size_probe.headers["Content-Range"].split("/")[1])
    save_response_content(response, save_path, file_size)


def get_confirm_token(response):
    """The value of drive's ``download_warning*`` cookie, to be echoed as
    ``confirm=``; None without one."""
    for key, value in response.cookies.items():
        if key.startswith("download_warning"):
            return value
    return None


def save_response_content(response, destination, file_size=None, chunk_size=32768):
    """Write ``response.iter_content`` to ``destination`` chunk by chunk,
    with a tqdm bar when the size is known."""
    pbar = None
    if file_size is not None:
        from tqdm import tqdm
        pbar = tqdm(total=math.ceil(file_size / chunk_size), unit="chunk")
        readable = sizeof_fmt(file_size)
    with open(destination, "wb") as f:
        downloaded = 0
        for chunk in response.iter_content(chunk_size):
            downloaded += chunk_size
            if pbar is not None:
                pbar.update(1)
                pbar.set_description(f"Download {sizeof_fmt(downloaded)} / {readable}")
            if chunk:
                f.write(chunk)
    if pbar is not None:
        pbar.close()
