"""Rank functions of the port's data-pipeline and callback tests
(``tests/test_torch_data.py``, ``tests/test_torch_callbacks.py``), run by
``horovod_tpu_torch.testing.run_cluster``. No jax import, so the spawned
ranks start fast."""

import torch


def callbacks_worker(seed: int) -> dict:
    """One rank: the broadcast callback (parameters and optimizer state
    from rank 1), the metric average, and the warmup's lr at every batch
    of 3 epochs at ``size()`` ranks."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import (BroadcastGlobalVariablesCallback,
                                             CallbackList,
                                             LearningRateWarmupCallback,
                                             MetricAverageCallback)

    r = hvd.rank()
    torch.manual_seed(seed + r)
    net = torch.nn.Linear(4, 3)
    opt = torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9)
    net(torch.randn(2, 4)).sum().backward()
    opt.step()  # momentum buffers that differ by rank
    before = {k: v.detach().numpy().copy()
              for k, v in net.state_dict().items()}
    state = {"params": net, "optimizer": opt, "lr": 0.1}
    cbs = CallbackList([BroadcastGlobalVariablesCallback(root_rank=1),
                        LearningRateWarmupCallback(warmup_epochs=2,
                                                   steps_per_epoch=3),
                        MetricAverageCallback()])
    cbs.on_train_begin(state)
    lrs, metrics = [], []
    for epoch in range(3):
        cbs.on_epoch_begin(epoch, state)
        for b in range(3):
            lrs.append(state["lr"])
            cbs.on_batch_end(b, state)
        m = {"loss": float(r + epoch), "acc": 10.0 * r}
        cbs.on_epoch_end(epoch, state, m)
        metrics.append(m)
    return {"rank": r, "before": before,
            "params": {k: v.detach().numpy().copy()
                       for k, v in net.state_dict().items()},
            "momentum": [opt.state[p]["momentum_buffer"].numpy().copy()
                         for p in net.parameters()],
            "lrs": lrs, "metrics": metrics}


def data_worker(root: str, batch: int, epochs: int) -> dict:
    """One rank of the real-data loop: a linear model over this rank's
    shard of ``root`` (``ShardedImageFolder``, ``set_epoch`` each epoch)
    through ``DistributedOptimizer``; the shards' indices and the final
    weights."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import ShardedImageFolder

    ds = ShardedImageFolder(root, batch_size=batch, image_size=8, seed=5)
    torch.manual_seed(0)
    net = torch.nn.Linear(8 * 8 * 3, 3)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.1),
        named_parameters=net.named_parameters())
    shards = []
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        shards.append(ds._indices().tolist())
        for x, y in ds:
            opt.zero_grad()
            logits = net(torch.from_numpy(x).reshape(x.shape[0], -1))
            torch.nn.functional.cross_entropy(
                logits, torch.from_numpy(y).long()).backward()
            opt.step()
    return {"rank": hvd.rank(), "size": ds.size, "shards": shards,
            "weight": net.weight.detach().numpy().copy()}
