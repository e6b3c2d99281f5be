"""``Ploter`` (``paddle_tpu/v2/plot/plot.py``): (step, value) series by
title, drawn with matplotlib where it can be imported; without it
``plot`` draws nothing and returns None, so a training loop runs the
same."""

from __future__ import annotations


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(float(value))

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *titles):
        self.__args__ = titles
        self.__plot_data__ = {t: PlotData() for t in titles}

    def __getitem__(self, title) -> PlotData:
        return self.__plot_data__[title]

    def append(self, title, step, value):
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        plt.figure()
        for title, data in self.__plot_data__.items():
            plt.plot(data.step, data.value, label=title)
        plt.legend()
        if path:
            plt.savefig(path)
        plt.close()
        return path

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
