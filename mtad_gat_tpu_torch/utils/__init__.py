from mtad_gat_tpu_torch.utils.plotting import Plotter, plot_losses

__all__ = ["plot_losses", "Plotter"]
