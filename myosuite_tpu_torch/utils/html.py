"""HTML helpers: embed rollout videos in reports.

The JAX package's `utils.html`, unchanged: pure Python.
"""

from __future__ import annotations

import base64
import os


def video_html(video_path: str, width: int = 480) -> str:
  """Base64-embedded <video> tag for a saved mp4."""
  with open(video_path, "rb") as f:
    data = base64.b64encode(f.read()).decode()
  return (f'<video width="{width}" controls autoplay loop>'
          f'<source src="data:video/mp4;base64,{data}" type="video/mp4">'
          "</video>")


def save_report(html_path: str, title: str, sections) -> str:
  """Write a minimal standalone report: sections = [(heading, html), ...]."""
  body = "\n".join(f"<h2>{h}</h2>\n{content}" for h, content in sections)
  doc = (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
         f"<title>{title}</title></head><body><h1>{title}</h1>\n"
         f"{body}\n</body></html>")
  os.makedirs(os.path.dirname(os.path.abspath(html_path)), exist_ok=True)
  with open(html_path, "w") as f:
    f.write(doc)
  return html_path
