"""The one rule for a media path that a client or an agent turn names.

Tools, engines and the server read uploaded clips, images and their own
outputs by paths relative to the media root (``/upload`` names a file by
its root-relative path; T2I returns ``image/<uuid8>.png``), or by the
root-joined paths that ``agent/tools.py`` ``new_media_path`` returns.
:func:`resolve_media` maps either form onto the file under the root, with
links and ``..`` resolved first, and refuses what resolves outside it.
The JAX package reads such paths against the working directory
(``audiogpt_tpu/agent/toolset.py:47-49``); the port does not.
"""

from __future__ import annotations

import os


def resolve_media(path: str, root: str) -> str:
    """The real path of ``path`` under ``root``: a relative path is joined
    to the root, an absolute one is taken as it is; either must resolve
    (``realpath``) inside the root, else ``ValueError``."""
    real_root = os.path.realpath(root)
    full = os.path.realpath(os.path.join(real_root, path.strip()))
    if os.path.commonpath([real_root, full]) != real_root:
        raise ValueError(f"{path!r} is outside the media root")
    return full
