"""Training statistics. A copy of ``Statistics`` of
``variational_mmt_tpu/utils/logging.py``: per-report accuracy, perplexity
and tokens per second, with the ELBO's parts (CE, KL, image loss) beside
them.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Statistics:
    loss: float = 0.0  # summed token CE
    kl: float = 0.0  # summed per-sentence KL
    img_loss: float = 0.0
    n_words: int = 0
    n_correct: int = 0
    n_sents: int = 0
    n_steps: int = 0
    start_time: float = field(default_factory=time.time)

    def update(
        self,
        loss: float,
        n_words: int,
        n_correct: int,
        n_sents: int = 0,
        kl: float = 0.0,
        img_loss: float = 0.0,
    ) -> None:
        self.loss += float(loss)
        self.kl += float(kl)
        self.img_loss += float(img_loss)
        self.n_words += int(n_words)
        self.n_correct += int(n_correct)
        self.n_sents += int(n_sents)
        self.n_steps += 1

    def merge(self, other: "Statistics") -> None:
        self.loss += other.loss
        self.kl += other.kl
        self.img_loss += other.img_loss
        self.n_words += other.n_words
        self.n_correct += other.n_correct
        self.n_sents += other.n_sents
        self.n_steps += other.n_steps

    def accuracy(self) -> float:
        return 100.0 * self.n_correct / max(1, self.n_words)

    def xent(self) -> float:
        return self.loss / max(1, self.n_words)

    def ppl(self) -> float:
        return math.exp(min(self.xent(), 100.0))

    def avg_kl(self) -> float:
        return self.kl / max(1, self.n_sents)

    def avg_img_loss(self) -> float:
        return self.img_loss / max(1, self.n_sents)

    def elapsed(self) -> float:
        return time.time() - self.start_time

    def tokens_per_sec(self) -> float:
        return self.n_words / max(1e-9, self.elapsed())

    def output(self, step: int, total: int, beta: float = 1.0, lr: Optional[float] = None) -> None:
        parts = [
            f"step {step}/{total}",
            f"acc {self.accuracy():.2f}",
            f"ppl {self.ppl():.2f}",
            f"kl {self.avg_kl():.3f}",
            f"beta {beta:.3f}",
        ]
        if self.img_loss:
            parts.append(f"img {self.avg_img_loss():.3f}")
        if lr is not None:
            parts.append(f"lr {lr:.2e}")
        parts.append(f"{self.tokens_per_sec():.0f} tok/s")
        parts.append(f"{self.elapsed():.0f}s")
        print("; ".join(parts))
        sys.stdout.flush()

    def scalars(self) -> Dict[str, float]:
        return {
            "xent": self.xent(),
            "ppl": self.ppl(),
            "accuracy": self.accuracy(),
            "kl": self.avg_kl(),
            "img_loss": self.avg_img_loss(),
            "tokens_per_sec": self.tokens_per_sec(),
        }
