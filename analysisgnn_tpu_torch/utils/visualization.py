"""Visualization exports on the host (counterpart of
``analysisgnn_tpu/utils/visualization.py``, the same code, so the two give
equal strings): a voice-coloured pianoroll as an SVG string and the graph
JSON of the reference's web-viz export schema (analysisgnn/utils/
visualization.py:55-89).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

_PALETTE = (
    "#4E79A7", "#F28E2B", "#E15759", "#76B7B2", "#59A14F",
    "#EDC948", "#B07AA1", "#FF9DA7", "#9C755F", "#BAB0AC",
)


def pianoroll_svg(
    note_array: np.ndarray,
    color_by: str = "voice",
    width: int = 900,
    height: int = 300,
) -> str:
    onset = note_array["onset_div"].astype(float)
    dur = np.maximum(note_array["duration_div"].astype(float), 0.5)
    pitch = note_array["pitch"].astype(float)
    groups = note_array[color_by].astype(int) if color_by in note_array.dtype.names else np.zeros(len(note_array), int)
    t_max = (onset + dur).max() or 1.0
    p_lo, p_hi = pitch.min() - 1, pitch.max() + 1
    sx = width / t_max
    sy = height / max(p_hi - p_lo, 1)
    rects = []
    for o, d, p, v in zip(onset, dur, pitch, groups):
        c = _PALETTE[int(v) % len(_PALETTE)]
        x, y = o * sx, (p_hi - p) * sy
        rects.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{max(d * sx, 1):.1f}" '
            f'height="{max(sy - 1, 1):.1f}" fill="{c}" rx="1"/>'
        )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">'
        f'<rect width="100%" height="100%" fill="white"/>' + "".join(rects) + "</svg>"
    )


def graph_to_json(
    note_array: np.ndarray,
    edges: Dict,
    predictions: Optional[Dict[str, list]] = None,
) -> str:
    """Graph → JSON for web visualization (reference :55-89 schema)."""
    nodes = [
        {
            "id": int(i),
            "onset": int(note_array["onset_div"][i]),
            "duration": int(note_array["duration_div"][i]),
            "pitch": int(note_array["pitch"][i]),
            "voice": int(note_array["voice"][i]),
            "staff": int(note_array["staff"][i]),
            **(
                {k: str(predictions[k][i]) for k in predictions}
                if predictions
                else {}
            ),
        }
        for i in range(len(note_array))
    ]
    links = []
    for et, ei in edges.items():
        rel = et[1] if isinstance(et, tuple) else str(et)
        for s, d in np.asarray(ei).T.tolist():
            links.append({"source": int(s), "target": int(d), "type": rel})
    return json.dumps({"nodes": nodes, "links": links})
