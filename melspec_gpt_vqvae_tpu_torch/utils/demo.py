"""ffmpeg discovery and audio extraction from a video.

The port's own copy of ``which_ffmpeg`` and ``extract_audio_from_video``
(feature_extraction/demo_utils.py:15-37; reference
feature_extraction/demo_utils.py:25-53), which ``find_raw_audio`` uses
for a clip whose source is an ``.mp4``.
"""

from __future__ import annotations

import shutil
import subprocess


def which_ffmpeg() -> str:
    """The path of ffmpeg, or '' where there is none."""
    return shutil.which("ffmpeg") or ""


def extract_audio_from_video(video_path: str, out_wav: str,
                             sample_rate: int = 22050) -> str:
    """A video's audio track as a mono 16-bit WAV at ``sample_rate``."""
    ffmpeg = which_ffmpeg()
    if not ffmpeg:
        raise RuntimeError("ffmpeg is not found; provide a .wav input "
                           "instead")
    cmd = [ffmpeg, "-i", video_path, "-vn", "-acodec", "pcm_s16le",
           "-ar", str(sample_rate), "-ac", "1", "-y", out_wav]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_wav
