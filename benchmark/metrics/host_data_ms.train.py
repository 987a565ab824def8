"""Host milliseconds a training micro-batch spends in the data plane: the
sampler and the batcher (span ``host_data``, around the feed's draw of the
next micro-batch), over the traced window. The batch's copy to the card
(``Trainer._index``) is left out: from pageable memory it waits for the
work the card already holds, so its span measures the card's backlog."""


def read(ctx):
    if ctx.kind != "train" or not ctx.micro_batches:
        return None
    return 1e3 * ctx.spans.total("host_data") / ctx.micro_batches
