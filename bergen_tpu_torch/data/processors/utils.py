"""Shared helpers for dataset processors (the PyTorch port's copy of
``bergen_tpu/data/processors/utils.py``; reference
``modules/processors/utils.py``)."""

from __future__ import annotations

from typing import Dict, List


def chunk_text(
    text: str,
    id: str,
    title: str | None = None,
    max_size: int = 1000,
    overlap: int = 200,
    words_or_chars: str = "chars",
) -> List[Dict[str, str]]:
    """Sliding-window chunking (by chars or words) with overlap; each chunk is
    title-prepended and id'd ``{id}_{chunk_id}`` — same semantics as reference
    ``modules/processors/utils.py:7-38`` (including dropping a final window that
    starts within `overlap` of the end)."""
    title = title or ""
    units = text.split() if words_or_chars == "words" else text
    chunks: List[Dict[str, str]] = []
    start = 0
    chunk_id = 0
    while start < len(units):
        end = start + max_size
        if start + overlap >= len(units):
            break
        piece = (
            " ".join(units[start:end]) if words_or_chars == "words" else units[start:end]
        )
        chunks.append({"id": f"{id}_{chunk_id}", "content": f"{title}: {piece}"})
        start = end - overlap
        chunk_id += 1
    return chunks


def listify_label(row: Dict) -> Dict:
    """'answer' -> ['answer'] so metrics always see a list of gold labels."""
    row["label"] = [row["label"]]
    return row
