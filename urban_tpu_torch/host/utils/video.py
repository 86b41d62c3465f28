"""ffmpeg video export (reference: khrylib/utils/tools.py:14-17)."""
from __future__ import annotations

import shutil
import subprocess


def save_video_ffmpeg(frame_str: str, out_file: str, fps: int = 30,
                      start_frame: int = 0, crf: int = 20) -> bool:
    if shutil.which('ffmpeg') is None:
        return False
    cmd = ['ffmpeg', '-y', '-r', f'{fps}', '-f', 'image2', '-start_number',
           f'{start_frame}', '-i', frame_str, '-vcodec', 'libx264', '-crf',
           f'{crf}', '-pix_fmt', 'yuv420p', out_file]
    subprocess.call(cmd)
    return True
