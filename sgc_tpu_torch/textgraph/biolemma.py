"""BioLemmatizer bridge (external Java tool, gated; the counterpart of
sgc_tpu/textgraph/biolemma.py).

The reference shells out to biolemmatizer-core-1.2-jar-with-dependencies.jar
in batched subprocess calls (reference
downstream/TextSGC_indexing/remove_words.py:201-219,
downstream/TextSGC_Bio/remove_words_v2.py:47-51). The jar and a JVM are
external artifacts; this module keeps the same batched-stdin protocol and
raises a clear error when either is missing.
"""

from __future__ import annotations

import os
import shutil
import subprocess

JAR_ENV = "SGC_TPU_BIOLEMMATIZER_JAR"


def _find_jar() -> str:
    jar = os.environ.get(JAR_ENV)
    if jar and os.path.exists(jar):
        return jar
    raise FileNotFoundError(
        f"BioLemmatizer jar not found; set {JAR_ENV} to the path of "
        "biolemmatizer-core-1.2-jar-with-dependencies.jar"
    )


def lemmatize_bio(tokens: list[str], batch_size: int = 1000) -> list[str]:
    """Lemmatize via the BioLemmatizer jar, one token per stdin line."""
    jar = _find_jar()
    if shutil.which("java") is None:
        raise RuntimeError("BioLemmatizer requires a java runtime on PATH")
    out: list[str] = []
    for i in range(0, len(tokens), batch_size):
        batch = tokens[i : i + batch_size]
        proc = subprocess.run(
            ["java", "-Xmx1G", "-jar", jar, "-l", "-t"],
            input="\n".join(batch),
            capture_output=True,
            text=True,
            check=True,
        )
        for line in proc.stdout.splitlines():
            parts = line.strip().split("\t")
            if parts and parts[0]:
                # output format: token<TAB>lemma ... — take the lemma
                out.append(parts[-1].split(" ")[0].lower())
    if len(out) != len(tokens):
        # Tool dropped/merged lines; fall back to identity to keep alignment.
        return tokens
    return out
