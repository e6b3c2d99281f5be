"""The v2 datasets (``paddle_tpu/v2/dataset/``), numpy and the standard
library only: mnist, cifar, imdb, imikolov, movielens, uci_housing,
conll05, sentiment, wmt14, flowers, mq2007 and voc2012.  Each reads the
real corpus from its cache (``~/.cache/paddle_tpu/dataset/<name>``, or
``$PADDLE_TPU_DATA_HOME``) and otherwise serves a deterministic
synthetic corpus with the original's record schema (tuple arity,
dtypes, vocabularies, image shapes), record for record the JAX
package's.  Nothing is downloaded: put the files in the cache to use
the real corpora."""

from paddle_tpu_torch.v2.dataset import (
    cifar,
    conll05,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_housing,
    voc2012,
    wmt14,
)

__all__ = ["mnist", "cifar", "imdb", "imikolov", "movielens", "uci_housing",
           "conll05", "sentiment", "wmt14", "flowers", "mq2007", "voc2012"]
