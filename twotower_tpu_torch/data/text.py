"""Vectorized text cleaning (the PyTorch port's own copy of
``twotower_tpu/data/text.py``).

Behavioral parity with the reference TextProcessor
(src/data/preprocessor.py:25-149): HTML unescape + tag strip, URL removal,
lowercasing, special-char removal keeping basic punctuation, whitespace
collapse, optional stopword removal/stemming, and a [min,max] length gate.

Implementation is columnar: ``clean_array`` joins the whole column with a
sentinel and runs each compiled regex ONCE over the joined corpus rather
than a per-row pandas ``.apply``; a per-row path (``clean_text``) remains
for word-level NLTK ops and sentinel-hostile inputs. Stopwords/stemming use
NLTK when available and degrade gracefully (reference: preprocessor.py:88-92).
"""

from __future__ import annotations

import html
import re

import numpy as np

from twotower_tpu_torch.config import PreprocessingConfig
from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

_HTML_TAG = re.compile(r"<[^>]+>")
_URL = re.compile(r"http[s]?://(?:[a-zA-Z]|[0-9]|[$-_@.&+]|[!*\(\),]|(?:%[0-9a-fA-F][0-9a-fA-F]))+")
_SPECIAL = re.compile(r"[^a-zA-Z0-9\s.,!?'-]")
_WS = re.compile(r"\s+")

# Batch variants for the joined-corpus fast path: rows are joined with a
# \x00 sentinel and the whole pipeline runs as ONE pass over one string, so
# every character class that could match or cross the sentinel excludes it.
# (\s, the URL charsets, and entity bodies already cannot produce or span
# \x00 — verified by the equality test against the per-row path.)
_SEP = "\x00"
_HTML_TAG_B = re.compile(r"<[^>\x00]+>")
# Specials-removal and whitespace-collapse fused, arranged so the plain
# single space — the overwhelmingly common case — never matches: a run of
# bad characters (special or non-space whitespace) becomes one space, then
# multi-space runs collapse. Equivalent to specials->space-each followed by
# \s+ collapse, but the substitutions only fire where text is actually
# dirty instead of on every word boundary in the corpus.
_SPECIAL_NS_B = re.compile(r"[^a-zA-Z0-9.,!?'\x00 -]+")
_MULTISPACE = re.compile(r"  +")


class TextProcessor:
    """Configurable text cleaner (reference: preprocessor.py:25-149)."""

    def __init__(self, config: PreprocessingConfig | None = None):
        self.config = config or PreprocessingConfig()
        self._stopwords: frozenset[str] | None = None
        self._stemmer = None
        if self.config.remove_stopwords or self.config.stem_words:
            self._setup_nltk()

    def _setup_nltk(self) -> None:
        """Lazy NLTK setup; degrades gracefully offline
        (reference: preprocessor.py:64-92)."""
        try:
            import nltk
            from nltk.corpus import stopwords
            from nltk.stem import PorterStemmer

            try:
                self._stopwords = frozenset(stopwords.words("english"))
            except LookupError:
                try:
                    nltk.download("stopwords", quiet=True)
                    self._stopwords = frozenset(stopwords.words("english"))
                except Exception:  # offline
                    logger.warning("NLTK stopwords unavailable; skipping stopword removal")
                    self._stopwords = None
            if self.config.stem_words:
                self._stemmer = PorterStemmer()
        except ImportError:
            logger.warning("NLTK not installed; stopwords/stemming disabled")

    # ------------------------------------------------------------------

    def clean_text(self, text: str) -> str:
        """Clean a single string (reference: preprocessor.py:94-145)."""
        if not text:
            return ""
        if self.config.remove_html:
            text = html.unescape(text)
            text = _HTML_TAG.sub("", text)
        if self.config.remove_urls:
            text = _URL.sub(" ", text)
        if self.config.lowercase:
            text = text.lower()
        if self.config.remove_special_chars:
            text = _SPECIAL.sub(" ", text)
        text = _WS.sub(" ", text).strip()
        if self._stopwords is not None or self._stemmer is not None:
            words = text.split()
            if self._stopwords is not None:
                words = [w for w in words if w not in self._stopwords]
            if self._stemmer is not None:
                words = [self._stemmer.stem(w) for w in words]
            text = " ".join(words)
        return text

    def clean_array(self, texts: np.ndarray) -> np.ndarray:
        """Clean a whole column in one regex pass.

        Rows are joined with a ``\\x00`` sentinel and the pipeline (HTML,
        URL, case, specials, whitespace) runs once over the joined corpus —
        each compiled regex scans one long string in C instead of being
        re-invoked per row, which is 5-10x faster than the per-row loop on
        review-length text (the reference's hottest pandas path, SURVEY
        §3.3: ``df["text"].apply(clean_text)``). Falls back to the per-row
        path when word-level NLTK ops are enabled, an input contains the
        sentinel, or HTML unescaping produces one (``&#0;``)."""
        rows = [t if t else "" for t in texts]
        if not rows:
            return np.array([], dtype=object)
        if (
            self._stopwords is not None
            or self._stemmer is not None
            or any(_SEP in t for t in rows)
        ):
            clean = self.clean_text
            return np.array([clean(t) for t in rows], dtype=object)

        n = len(rows)
        joined = _SEP.join(rows)
        if self.config.remove_html:
            unescaped = html.unescape(joined)
            if unescaped.count(_SEP) != n - 1:  # an &#0; alias appeared
                clean = self.clean_text
                return np.array([clean(t) for t in rows], dtype=object)
            joined = _HTML_TAG_B.sub("", unescaped)
        if self.config.remove_urls:
            joined = _URL.sub(" ", joined)
        if self.config.lowercase:
            joined = joined.lower()
        if self.config.remove_special_chars:
            joined = _MULTISPACE.sub(" ", _SPECIAL_NS_B.sub(" ", joined))
        else:
            # C-level whitespace collapse; \x00 is not str whitespace, so
            # sentinels ride through split() inside tokens.
            joined = " ".join(joined.split())
        # The per-row strip: after collapse each sentinel boundary carries
        # at most one space per side.
        joined = joined.replace(" \x00", _SEP).replace("\x00 ", _SEP).strip(" ")
        return np.array(joined.split(_SEP), dtype=object)

    def validate_text_length(self, text: str) -> bool:
        """Length gate [min_text_length, max_text_length]
        (reference: preprocessor.py:147-149)."""
        f = self.config.filtering
        return f.min_text_length <= len(text) <= f.max_text_length

    def length_mask(self, texts: np.ndarray) -> np.ndarray:
        f = self.config.filtering
        lengths = np.array([len(t) for t in texts], dtype=np.int64)
        return (lengths >= f.min_text_length) & (lengths <= f.max_text_length)
