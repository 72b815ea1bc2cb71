"""Content-moderation hook (reference psalm/utils.py:102-126).

``violates_moderation`` posts the text to the OpenAI moderation API and
returns the ``flagged`` verdict; any failure (no OPENAI_API_KEY, no network,
malformed response) fails OPEN (returns False), exactly like the reference.
Implemented with urllib (the image ships no ``requests``).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

MODERATION_MSG = ("YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. "
                  "PLEASE TRY AGAIN.")


def violates_moderation(text: str, timeout: float = 5.0) -> bool:
    """True when the moderation endpoint flags the text; False otherwise."""
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    url = "https://api.openai.com/v1/moderations"
    payload = json.dumps({"input": text.replace("\n", "")}).encode("utf-8")
    req = urllib.request.Request(
        url, data=payload,
        headers={"Content-Type": "application/json",
                 "Authorization": "Bearer " + api_key})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return bool(json.load(resp)["results"][0]["flagged"])
    except (urllib.error.URLError, KeyError, IndexError, ValueError,
            TimeoutError, OSError):
        return False
